"""The block-parallel canonical-Huffman table walks.

Two ops share one lane arithmetic (``walk.cuh`` on the card):

    hufdec(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
           block_size) -> codes (C, NB*block_size) int32
    hufdec_tiles(...same arguments...) -> codes (C, NB*block_size) int32

words2 (C, W) int32 holding the u32 wire words (u64 words split
MSB-first), nbits2 (C, NB) per-block bit counts, counts (C,) valid
symbols per row, sym/len_flat (K*2^16,) stacked decode tables selected
per row by cb_idx (C,). Symbol s of block b lands at b*block_size + s;
positions past a row's count are 0.

`hufdec` is the split decode route's walk (the reference's
``src/repro/kernels/hufdec``): every lane (one per (chunk, block))
starts at the exclusive int32 cumsum of its row's block bit counts and
walks inside the whole row. `hufdec_tiles` walks inside a word WINDOW:
lanes are grouped in tiles of ``tile_blocks`` blocks, and a tile's
window of ``win`` words starts where its first block's bits start
(clamped into the zero-padded row), exactly as the reference's
word-tiled TPU kernel (``src/repro/kernels/megakernel/decode_kernel.py::
hufdec_tiles``) places them. With one tile per row and ``win = W`` the
windowed walk is the unwindowed one, and the decode megakernel's walk.
On valid streams no window binds. On corrupted bits the cursor is
clamped into the window and words past the row read as zero, so a lane
never reads outside its row and stops after min(count, block_size)
steps.

  * :func:`walk_plain` — lock-step plain PyTorch over all lanes (u32
    words in int64, as CPU ``torch.uint32`` has no shifts);
    :func:`hufdec_plain` and :func:`hufdec_tiles_plain` are its two
    layouts;
  * :func:`hufdec_cuda` and :func:`hufdec_tiles_cuda` — csrc/hufdec.cu,
    one thread per lane.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .. import dispatch

MAX_CODE_BITS = 16
TBL = 1 << MAX_CODE_BITS
TILE_VALUES = 1 << 15          # values per tile of the word-tiled walk
_M32 = 0xFFFFFFFF
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_WALK_ARGS = [_P, _I64, _I64, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _P]
_HUFDEC_ARGS = [_P, _I64, _I64, _P, _P, _P, _P, _I64, _I64, _P, _P]
_MAX_ROWS = 65535                 # gridDim.y of the walk kernels


def tile_geometry(block_size: int) -> Tuple[int, int]:
    """(blocks per tile, window words) of the word-tiled walk: a tile
    spans at most tile*block_size*16 payload bits, plus 3 words of slack
    (start-bit skew, the second peek word, rounding)."""
    tb = max(1, TILE_VALUES // block_size)
    return tb, (tb * block_size * MAX_CODE_BITS) // 32 + 3


def lane_layout(nbits2: torch.Tensor, tile_blocks: int, win: int, W: int):
    """-> (lane_start, lane_foff), both (C, NB) int32: each lane's first
    cursor relative to its tile's window, and the window's first word.

    Block starts are the exclusive cumsum of nbits2 wrapped to int32
    (the reference's cumsum dtype); a tile's window starts at its first
    block's word, clamped so it fits the row zero-padded to max(W, win).
    """
    C, NB = nbits2.shape
    nt = -(-NB // tile_blocks)
    nb = torch.nn.functional.pad(nbits2.to(torch.int64),
                                 (0, nt * tile_blocks - NB))
    excl = (torch.cumsum(nb, 1) - nb).to(torch.int32)
    g0 = excl.reshape(C, nt, tile_blocks)[:, :, 0]
    foff = torch.clamp(g0 >> 5, 0, max(W, win) - win)
    lane_foff = foff.repeat_interleave(tile_blocks, dim=1)[:, :NB]
    lane_start = (excl[:, :NB].to(torch.int64)
                  - lane_foff.to(torch.int64) * 32).to(torch.int32)
    return lane_start, lane_foff.contiguous()


def lane_counts(counts: torch.Tensor, NB: int, block_size: int):
    """(C, NB) symbols each lane decodes: min(count - b*bs, bs) >= 0."""
    b = torch.arange(NB, device=counts.device, dtype=torch.int64)
    return torch.clamp(counts.to(torch.int64)[:, None] - b * block_size,
                       0, block_size)


def walk_plain(words2: torch.Tensor, nbits2: torch.Tensor,
               counts: torch.Tensor, sym_flat: torch.Tensor,
               len_flat: torch.Tensor, cb_idx: torch.Tensor,
               block_size: int, tile_blocks: int, win: int) -> torch.Tensor:
    """The windowed walk in plain PyTorch -> (C, NB*block_size) int32."""
    C, W = words2.shape
    NB = nbits2.shape[1]
    dev = words2.device
    lane_start, lane_foff = lane_layout(nbits2, tile_blocks, win, W)
    words = torch.nn.functional.pad(words2.to(torch.int64) & _M32,
                                    (0, max(W, win) - W))
    foff = lane_foff.to(torch.int64)
    cursor = lane_start.to(torch.int64)
    cmax = (win - 2) * 32 + 31
    cnt = lane_counts(counts, NB, block_size)
    tbl_off = cb_idx.to(torch.int64)[:, None] * TBL
    sym_flat = sym_flat.to(torch.int32)
    len_flat = len_flat.to(torch.int64)
    out = torch.zeros((C, NB, block_size), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    steps = int(cnt.max()) if cnt.numel() else 0
    for i in range(steps):
        cur = cursor.clamp(0, cmax)
        w = foff + (cur >> 5)
        b = cur & 31
        x0 = torch.gather(words, 1, w)
        x1 = torch.gather(words, 1, w + 1)
        window = ((x0 << b) & _M32) | torch.where(b > 0, x1 >> (32 - b), zero)
        idx = tbl_off + (window >> (32 - MAX_CODE_BITS))
        active = cnt > i
        out[:, :, i] = torch.where(active, sym_flat[idx], 0)
        cursor = cursor + torch.where(active, len_flat[idx], zero)
    return out.reshape(C, NB * block_size)


def _check_rows(name: str, words2: torch.Tensor) -> None:
    """The walk peeks two words, so a row holds at least two."""
    if words2.ndim != 2 or words2.shape[1] < 2:
        raise ValueError(f"{name}: words2 (C, W) with W >= 2 expected, got "
                         f"{tuple(words2.shape)}")


def hufdec_plain(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                 block_size: int) -> torch.Tensor:
    """The split route's walk: one window per row, the whole row."""
    _check_rows("hufdec", words2)
    return walk_plain(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                      block_size, nbits2.shape[1], words2.shape[1])


def hufdec_tiles_plain(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                       block_size: int) -> torch.Tensor:
    tb, win = tile_geometry(block_size)
    return walk_plain(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                      block_size, tb, win)


def packed_table(sym_flat: torch.Tensor, len_flat: torch.Tensor):
    """(len << 16) | sym as int32: the kernels' one-load table entry."""
    return ((len_flat.to(torch.int32) << 16)
            | sym_flat.to(torch.int32)).contiguous()


def hufdec_tiles_cuda(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                      block_size: int) -> torch.Tensor:
    """csrc/hufdec.cu: one thread per (chunk, block) lane."""
    dispatch.require_cuda("hufdec_tiles", words2, nbits2, counts, sym_flat,
                          len_flat, cb_idx)
    C, W = words2.shape
    NB = nbits2.shape[1]
    if words2.dtype != torch.int32:
        raise ValueError("hufdec_tiles: words2 must be int32 u32 bits")
    tb, win = tile_geometry(block_size)
    lane_start, lane_foff = lane_layout(nbits2, tb, win, W)
    table = packed_table(sym_flat, len_flat)
    counts = counts.to(torch.int32).contiguous()
    cb_idx = cb_idx.to(torch.int32).contiguous()
    out = torch.empty((C, NB * block_size), dtype=torch.int32,
                      device=words2.device)
    dispatch.count_launch("hufdec_tiles")
    rc = _build.function("ceaz_hufdec_tiles", _WALK_ARGS)(
        words2.data_ptr(), C, W, lane_start.data_ptr(), lane_foff.data_ptr(),
        counts.data_ptr(), table.data_ptr(), cb_idx.data_ptr(), NB,
        block_size, win, out.data_ptr(), dispatch.stream_handle())
    _build.check(rc, "hufdec_tiles")
    return out


def hufdec_cuda(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                block_size: int) -> torch.Tensor:
    """csrc/hufdec.cu ``ceaz_hufdec``: one thread per (chunk, block)
    lane over the whole row; the lanes' first cursors are scanned in the
    kernel."""
    dispatch.require_cuda("hufdec", words2, nbits2, counts, sym_flat,
                          len_flat, cb_idx)
    _check_rows("hufdec", words2)
    C, W = words2.shape
    NB = nbits2.shape[1]
    if words2.dtype != torch.int32:
        raise ValueError("hufdec: words2 must be int32 u32 bits")
    if C > _MAX_ROWS:
        raise ValueError(f"hufdec: at most {_MAX_ROWS} rows per launch")
    i32 = lambda t: t.to(torch.int32).contiguous()
    nbits2, counts, cb_idx = map(i32, (nbits2, counts, cb_idx))
    table = packed_table(sym_flat, len_flat)
    out = torch.empty((C, NB * block_size), dtype=torch.int32,
                      device=words2.device)
    dispatch.count_launch("hufdec")
    rc = _build.function("ceaz_hufdec", _HUFDEC_ARGS)(
        words2.data_ptr(), C, W, nbits2.data_ptr(), counts.data_ptr(),
        table.data_ptr(), cb_idx.data_ptr(), NB, block_size, out.data_ptr(),
        dispatch.stream_handle())
    _build.check(rc, "hufdec")
    return out
