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
  * :func:`hufdec_tiles_cuda` and :func:`hufdec_cuda` — csrc/hufdec.cu
    ``ceaz_hufdec_tiles``, the warp walk (csrc/warp_walk.cuh): a warp
    per block, self-synchronising segments against the decode table held
    whole in shared memory as 16-bit entries (:func:`packed_table16`),
    each block kept only under the exact acceptance rule stated there and
    otherwise walked by ``walk_lane`` in the same kernel. `hufdec_tiles`
    launches it with the word-tiled windows (:func:`tile_geometry`),
    `hufdec` with one window a row (:func:`row_geometry`). Both take any
    row count. :func:`walk_stats` reads how many blocks took each path.
    The wrappers raise on a table entry outside the 16-bit entry's
    ranges: they wait on the card for that unless the caller checked the
    tables on the host (:func:`mark_ranges_checked`), as both decode
    routes do (``runtime/fused_decode.py``).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch

from .. import _build
from .. import dispatch

MAX_CODE_BITS = 16
TBL = 1 << MAX_CODE_BITS
SYM_BITS = 10                  # symbols < NUM_SYMBOLS in a 16-bit entry
NUM_SYMBOLS = 1 << SYM_BITS
TILE_VALUES = 1 << 15          # values per tile of the word-tiled walk
_M32 = 0xFFFFFFFF
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_WALK_ARGS = [_P, _I64, _I64, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
              _P, _P, _P, _P]
_PACK_ARGS = [_P, _P, _I64, _P, _P, _P, _P]


def tile_geometry(block_size: int) -> Tuple[int, int]:
    """(blocks per tile, window words) of the word-tiled walk: a tile
    spans at most tile*block_size*16 payload bits, plus 3 words of slack
    (start-bit skew, the second peek word, rounding)."""
    tb = max(1, TILE_VALUES // block_size)
    return tb, (tb * block_size * MAX_CODE_BITS) // 32 + 3


def row_geometry(W: int) -> Tuple[int, int]:
    """(blocks per tile, window words) that make the word-tiled walk the
    split route's: one window of the whole row (W words), so every window
    starts at word 0 and a lane's cursor is its row-relative first bit.
    Tiles of one block: the tile's first block is the lane's own, so no
    lane sums the bit counts of blocks before it in its tile."""
    return 1, W


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
                      block_size, *row_geometry(words2.shape[1]))


def hufdec_tiles_plain(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                       block_size: int) -> torch.Tensor:
    tb, win = tile_geometry(block_size)
    return walk_plain(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                      block_size, tb, win)


def packed_table(sym_flat: torch.Tensor, len_flat: torch.Tensor):
    """(len << 16) | sym as int32: the kernels' one-load table entry."""
    return ((len_flat.to(torch.int32) << 16)
            | sym_flat.to(torch.int32)).contiguous()


def check_table_ranges(sym, ln) -> None:
    """Raise ValueError unless every symbol lies in [0, 1024) and every
    length in [0, 16], the ranges of the 16-bit entry. numpy arrays or
    tensors (on a CUDA tensor it waits for the card)."""
    if bool(((sym < 0) | (sym >= NUM_SYMBOLS)).any()
            | ((ln < 0) | (ln > MAX_CODE_BITS)).any()):
        raise ValueError("decode table: an entry has a symbol outside "
                         f"[0, {NUM_SYMBOLS}) or a length outside [0, "
                         f"{MAX_CODE_BITS}]")


def mark_ranges_checked(*tables: torch.Tensor) -> None:
    """Mark decode tables whose ranges the caller checked where it built
    them (on the host, :func:`check_table_ranges`): the warp walks'
    wrappers then skip their own check, which waits for the card. A
    later in-place change drops the mark. (Inference tensors keep no
    version, so they are never marked.)"""
    for t in tables:
        if not t.is_inference():
            t._ceaz_ranges_checked = t._version


def ranges_checked(t: torch.Tensor) -> bool:
    return (not t.is_inference()
            and getattr(t, "_ceaz_ranges_checked", None) == t._version)


def packed_table16(sym_flat: torch.Tensor, len_flat: torch.Tensor):
    """(len << 10) | sym as int16: the warp walk's shared-memory entry,
    exact for sym in [0, 1024) and len in [0, 16]; raises ValueError on an
    entry outside those ranges. (The plain version of the table half of
    ``ceaz_pack_tables``.)"""
    sym = sym_flat.to(torch.int32)
    ln = len_flat.to(torch.int32)
    check_table_ranges(sym, ln)
    return ((ln << SYM_BITS) | sym).to(torch.int16).contiguous()


# the warp walks' counters, one int32 tensor per (kernel, device), added
# to by every launch (as dispatch's launch counts): blocks walked by
# walk_lane, blocks kept from the fast path, the most sync rounds one
# block took
_STATS: Dict[Tuple[str, int], torch.Tensor] = {}
_STAT_KEYS = ("exact_blocks", "fast_blocks", "max_sync_rounds")
# the kernels that keep them: the warp walk under each op that launches it
WARP_WALKS = ("hufdec_tiles", "ceaz_chunk_dec_fused", "hufdec")


def stats_tensor(name: str, device) -> torch.Tensor:
    device = torch.device(device)
    key = (name, device.index if device.index is not None
           else torch.cuda.current_device())
    t = _STATS.get(key)
    if t is None:
        t = _STATS[key] = torch.zeros(len(_STAT_KEYS), dtype=torch.int32,
                                      device=device)
    return t


def walk_stats(name: str) -> Dict[str, int]:
    """The counters of kernel `name` (one of :data:`WARP_WALKS`) since
    the last :func:`reset_walk_stats`, over every device (syncs)."""
    out = dict.fromkeys(_STAT_KEYS, 0)
    for (n, _), t in _STATS.items():
        if n == name:
            exact, fast, rounds = t.tolist()
            out["exact_blocks"] += exact
            out["fast_blocks"] += fast
            out["max_sync_rounds"] = max(out["max_sync_rounds"], rounds)
    return out


def reset_walk_stats() -> None:
    for t in _STATS.values():
        t.zero_()


def pack_tables_cuda(name: str, sym_flat, len_flat
                     ) -> Tuple[torch.Tensor, torch.Tensor, Callable]:
    """csrc/hufdec.cu ``ceaz_pack_tables``: -> (t32, t16, check), the
    32-bit entries of :func:`packed_table` (walk_lane's) and the 16-bit
    ones of :func:`packed_table16`, in one pass. Call ``check()`` once
    the walk is launched, or its launch failed: for tables not marked by
    :func:`mark_ranges_checked` it waits for the packer alone and raises
    ValueError if an entry was out of range (the packer sets a flag in
    pinned host memory, which the card writes at its host address); for
    marked tables it does nothing."""
    if sym_flat.numel() != len_flat.numel() or sym_flat.numel() % TBL \
            or sym_flat.numel() == 0:
        raise ValueError(f"{name}: sym_flat/len_flat must hold K >= 1 "
                         f"tables of {TBL} entries")
    checked = ranges_checked(sym_flat) and ranges_checked(len_flat)
    sym = sym_flat.to(torch.int32).contiguous()
    ln = len_flat.to(torch.int32).contiguous()
    t32 = torch.empty(sym.numel(), dtype=torch.int32, device=sym.device)
    t16 = torch.empty(sym.numel(), dtype=torch.int16, device=sym.device)
    # marked tables set no flag: one on the card, never read
    flag = (torch.empty(1, dtype=torch.int32, device=sym.device) if checked
            else torch.zeros(1, dtype=torch.int32, pin_memory=True))
    rc = _build.function("ceaz_pack_tables", _PACK_ARGS)(
        sym.data_ptr(), ln.data_ptr(), sym.numel(), t32.data_ptr(),
        t16.data_ptr(), flag.data_ptr(), dispatch.stream_handle())
    _build.check(rc, f"{name} table pack")
    if checked:
        return t32, t16, lambda: None
    done = torch.cuda.Event()
    done.record()

    def check() -> None:
        done.synchronize()
        if int(flag[0]):
            raise ValueError(f"{name}: a decode table entry has a symbol "
                             f"outside [0, {NUM_SYMBOLS}) or a length "
                             f"outside [0, {MAX_CODE_BITS}]")
    return t32, t16, check


def _warp_walk(name: str, words2, nbits2, counts, sym_flat, len_flat,
               cb_idx, block_size: int, tb: int, win: int) -> torch.Tensor:
    """csrc/hufdec.cu ``ceaz_hufdec_tiles`` in windows of `win` words
    placed every `tb` blocks: the launch, counted under `name`, its
    counters in ``walk_stats(name)``."""
    dispatch.require_cuda(name, words2, nbits2, counts, sym_flat, len_flat,
                          cb_idx)
    C, W = words2.shape
    NB = nbits2.shape[1]
    if words2.dtype != torch.int32:
        raise ValueError(f"{name}: words2 must be int32 u32 bits")
    i32 = lambda t: t.to(torch.int32).contiguous()
    words2, nbits2, counts, cb_idx = map(i32, (words2, nbits2, counts,
                                               cb_idx))
    t32, t16, check = pack_tables_cuda(name, sym_flat, len_flat)
    out = torch.empty((C, NB * block_size), dtype=torch.int32,
                      device=words2.device)
    ticket = torch.empty(1, dtype=torch.int32, device=words2.device)
    dispatch.count_launch(name)
    try:
        rc = _build.function("ceaz_hufdec_tiles", _WALK_ARGS)(
            words2.data_ptr(), C, W, nbits2.data_ptr(), counts.data_ptr(),
            t32.data_ptr(), t16.data_ptr(), cb_idx.data_ptr(), NB,
            block_size, tb, win, out.data_ptr(),
            stats_tensor(name, words2.device).data_ptr(),
            ticket.data_ptr(), dispatch.stream_handle())
        _build.check(rc, name)
    finally:
        check()
    return out


def hufdec_tiles_cuda(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                      block_size: int) -> torch.Tensor:
    """The warp walk in the word-tiled windows (:func:`tile_geometry`),
    one warp a (chunk, block) lane; first cursors and tile windows found
    in the kernel; any row count."""
    return _warp_walk("hufdec_tiles", words2, nbits2, counts, sym_flat,
                      len_flat, cb_idx, block_size,
                      *tile_geometry(block_size))


def hufdec_cuda(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                block_size: int) -> torch.Tensor:
    """The split route's walk on the card: the warp walk with one window
    a row (:func:`row_geometry`); any row count."""
    dispatch.require_cuda("hufdec", words2, nbits2, counts, sym_flat,
                          len_flat, cb_idx)
    _check_rows("hufdec", words2)
    return _warp_walk("hufdec", words2, nbits2, counts, sym_flat, len_flat,
                      cb_idx, block_size, *row_geometry(words2.shape[1]))
