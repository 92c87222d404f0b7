"""The `hufenc` op: pass 2's Huffman gather-pack of every chunk row.

    encode_pack(codes2, valid2, lengths_tbl, cwords_tbl, block_size, w32)
      -> (words (C, w32) int32 holding u32 bits, block_nbits (C, nblocks))

codes2 (C, cv) int32 symbols, valid2 (C, cv) bool, one codebook row per
chunk: lengths_tbl / cwords_tbl (C, 1024) int32. The payload is the
contiguous MSB-first bitstream of the reference's ``hufenc`` op
(``src/repro/kernels/hufenc/ref.py::encode_pack``), cut at u32 grain
and truncated at w32 words; block_nbits counts valid symbols' bits.

  * :func:`encode_pack_plain` — plain PyTorch: each symbol's shifted
    codeword halves are summed into their words with ``index_add_``
    (bits of distinct symbols are disjoint, so the sum is the OR). u32
    words ride in int64 because CPU ``torch.uint32`` has no shifts.
  * :func:`encode_pack_cuda`  — the kernels of csrc/hufenc.cu.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .. import dispatch

NUM_SYMBOLS = 1024
_M32 = 0xFFFFFFFF
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SUMS_ARGS = [_P, _P, _P, _I64, _I64, _I64, _I64, _P, _P]
_PACK_ARGS = [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _P, _I64, _P, _P]


def _nblocks(cv: int, block_size: int) -> int:
    return max(1, -(-cv // block_size))


def encode_pack_plain(codes2: torch.Tensor, valid2: torch.Tensor,
                      lengths_tbl: torch.Tensor, cwords_tbl: torch.Tensor,
                      block_size: int, w32: int):
    C, cv = codes2.shape
    dev = codes2.device
    codes = codes2.to(torch.int64).clamp(0, NUM_SYMBOLS - 1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    lens = torch.where(valid2, torch.gather(lengths_tbl.to(torch.int64), 1,
                                            codes), zero)
    vals = torch.where(valid2, torch.gather(
        cwords_tbl.to(torch.int64) & _M32, 1, codes), zero)
    nblocks = _nblocks(cv, block_size)
    lens_p = torch.nn.functional.pad(lens, (0, nblocks * block_size - cv))
    block_nbits = lens_p.reshape(C, nblocks, block_size).sum(2)

    ends = torch.cumsum(lens, 1)
    starts = ends - lens
    word = starts >> 5
    left = 32 - (starts & 31) - lens                 # < 0: spills a word
    hi = torch.where(left >= 0, (vals << left.clamp(0, 31)) & _M32,
                     vals >> (-left).clamp(0, 31))
    lo = torch.where(left < 0, (vals << (32 + left).clamp(0, 31)) & _M32,
                     zero)
    row = torch.arange(C, device=dev)[:, None] * w32
    words = torch.zeros(C * w32, dtype=torch.int64, device=dev)
    live = lens > 0
    for part, w in ((hi, word), (lo, word + 1)):
        keep = live & (w < w32)
        words.index_add_(0, (row + w)[keep], part[keep])
    return (words.reshape(C, w32).to(torch.int32),
            block_nbits.to(torch.int32))


def encode_pack_cuda(codes2: torch.Tensor, valid2: torch.Tensor,
                     lengths_tbl: torch.Tensor, cwords_tbl: torch.Tensor,
                     block_size: int, w32: int):
    """csrc/hufenc.cu: block sums, torch exclusive cumsum, pack."""
    dispatch.require_cuda("hufenc", codes2, valid2, lengths_tbl, cwords_tbl)
    for name, t, dt in (("codes2", codes2, torch.int32),
                        ("valid2", valid2, torch.bool),
                        ("lengths_tbl", lengths_tbl, torch.int32),
                        ("cwords_tbl", cwords_tbl, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"hufenc: {name} must be {dt}, got {t.dtype}")
    C, cv = codes2.shape
    if valid2.shape != codes2.shape or lengths_tbl.shape != (C, NUM_SYMBOLS) \
            or cwords_tbl.shape != (C, NUM_SYMBOLS):
        raise ValueError("hufenc: codes2/valid2 (C, cv) and codebook "
                         f"tables (C, {NUM_SYMBOLS}) expected")
    dev = codes2.device
    nblocks = _nblocks(cv, block_size)
    block_nbits = torch.empty((C, nblocks), dtype=torch.int32, device=dev)
    words = torch.zeros((C, w32), dtype=torch.int32, device=dev)
    stream = dispatch.stream_handle()
    dispatch.count_launch("gather_pack_tiled")
    rc = _build.function("ceaz_hufenc_block_sums", _SUMS_ARGS)(
        codes2.data_ptr(), valid2.data_ptr(), lengths_tbl.data_ptr(), C, cv,
        block_size, nblocks, block_nbits.data_ptr(), stream)
    _build.check(rc, "gather_pack_tiled block sums")
    # each block's first bit: exclusive int32 cumsum, as the reference
    base = (torch.cumsum(block_nbits, 1, dtype=torch.int64)
            - block_nbits).to(torch.int32)
    rc = _build.function("ceaz_hufenc_pack", _PACK_ARGS)(
        codes2.data_ptr(), valid2.data_ptr(), lengths_tbl.data_ptr(),
        cwords_tbl.data_ptr(), C, cv, block_size, nblocks, base.data_ptr(),
        w32, words.data_ptr(), stream)
    _build.check(rc, "gather_pack_tiled pack")
    return words, block_nbits
