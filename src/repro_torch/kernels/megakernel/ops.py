"""The `ceaz_chunk_dec` op: the decode megakernel (decode half only).

    ceaz_chunk_dec(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                   odelta2, base, seg0, islor, block_size)
      -> q (C, NB*block_size) int32

The contract of the reference's op (``src/repro/kernels/megakernel/
ref.py``, below ``ceaz_chunk_dec``): table walk, then the outlier patch
(code 0 is the escape symbol and a row's stored deltas are in ascending
position order, so the r-th zero code takes odelta2[r] — a rank
gather, r clamped into [0, Ko-1]), then the inverse dual-quant: rows
with ``islor`` take the segmented Lorenzo prefix sum (the carry resets
where ``seg0[c] == c``; a segment's rows are contiguous and ascending),
the others ``delta + base``. Positions past a row's count are 0. All
sums wrap mod 2^32 like the reference's int32.

Two regimes behind one signature, the switch of the reference's
``megakernel/ops.py:110-140``:

  * rows of at most ``DEC_FUSE_LIMIT`` values — the fused kernel
    (csrc/decode_fused.cu), walk + patch + inverse;
  * larger rows — the word-tiled walk kernel (kernels/hufdec) and the
    plain :func:`patch_and_inverse` tail on the card.

:func:`ceaz_chunk_dec_plain` is the plain PyTorch version of both.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .. import dispatch
from ..hufdec import ops as hufdec

RADIUS = 512
DEC_FUSE_LIMIT = 1 << 17
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ROWS_ARGS = [_P, _I64, _I64, _P, _P, _P, _P, _P, _I64, _P, _P, _I64, _I64,
              _P, _P, _P, _P]
_ADD_ARGS = [_P, _P, _P, _P, _I64, _I64, _I64, _P, _P]


def patch_and_inverse(codes2, counts, odelta2, base, seg0, islor):
    """codes -> reconstruction codes q (plain PyTorch, any device); the
    reference's ``ref.patch_and_inverse``, with the prefix sums taken in
    int64 and wrapped once at the end (same residues mod 2^32)."""
    C, N = codes2.shape
    dev = codes2.device
    Ko = odelta2.shape[1]
    codes = codes2.to(torch.int64)
    pos = torch.arange(N, device=dev)
    valid = pos[None, :] < counts.to(torch.int64)[:, None]
    is_out = valid & (codes == 0)
    io = is_out.to(torch.int64)
    rank = torch.cumsum(io, 1) - io                 # exclusive zero-count
    dval = torch.gather(odelta2.to(torch.int64), 1, rank.clamp(0, Ko - 1))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    delta = torch.where(is_out, dval, codes - RADIUS)
    delta = torch.where(valid, delta, zero)
    local = torch.cumsum(delta, 1)
    carry = segment_carry(local[:, -1], seg0)
    q_lor = local + carry[:, None]
    q_val = delta + base.to(torch.int64)[:, None]
    q = torch.where(islor.to(torch.bool)[:, None], q_lor, q_val)
    return torch.where(valid, q, zero).to(torch.int32)


def segment_carry(row_sum: torch.Tensor, seg0: torch.Tensor) -> torch.Tensor:
    """Segmented exclusive scan of the row sums, resetting at seg0, as
    int64 (callers wrap): carry[c] = sum(row_sum[seg0[c]:c])."""
    dsum = row_sum.to(torch.int64)
    carry_all = torch.cumsum(dsum, 0) - dsum
    return carry_all - carry_all[seg0.to(torch.int64)]


def ceaz_chunk_dec_plain(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                         odelta2, base, seg0, islor, block_size: int):
    C, W = words2.shape
    NB = nbits2.shape[1]
    if NB * block_size <= DEC_FUSE_LIMIT:
        codes = hufdec.walk_plain(words2, nbits2, counts, sym_flat, len_flat,
                                  cb_idx, block_size, NB, W)
    else:
        codes = hufdec.hufdec_tiles_plain(words2, nbits2, counts, sym_flat,
                                          len_flat, cb_idx, block_size)
    return patch_and_inverse(codes, counts, odelta2, base, seg0, islor)


def ceaz_chunk_dec_fused_cuda(words2, nbits2, counts, sym_flat, len_flat,
                              cb_idx, odelta2, base, seg0, islor,
                              block_size: int) -> torch.Tensor:
    """csrc/decode_fused.cu: rows kernel, torch segment carry, add."""
    args = (words2, nbits2, counts, sym_flat, len_flat, cb_idx, odelta2,
            base, seg0, islor)
    dispatch.require_cuda("ceaz_chunk_dec_fused", *args)
    C, W = words2.shape
    NB = nbits2.shape[1]
    Ko = odelta2.shape[1]
    if words2.dtype != torch.int32 or odelta2.dtype != torch.int32:
        raise ValueError("ceaz_chunk_dec_fused: words2/odelta2 must be int32")
    dev = words2.device
    lane_start, _ = hufdec.lane_layout(nbits2, NB, W, W)
    table = hufdec.packed_table(sym_flat, len_flat)
    i32 = lambda t: t.to(torch.int32).contiguous()
    counts, cb_idx, base, islor = map(i32, (counts, cb_idx, base, islor))
    out = torch.empty((C, NB * block_size), dtype=torch.int32, device=dev)
    scratch = torch.empty((C, 2 * NB), dtype=torch.int32, device=dev)
    row_sum = torch.empty(C, dtype=torch.int32, device=dev)
    stream = dispatch.stream_handle()
    dispatch.count_launch("ceaz_chunk_dec_fused")
    rc = _build.function("ceaz_dec_rows", _ROWS_ARGS)(
        words2.data_ptr(), C, W, lane_start.data_ptr(), counts.data_ptr(),
        table.data_ptr(), cb_idx.data_ptr(), odelta2.data_ptr(), Ko,
        base.data_ptr(), islor.data_ptr(), NB, block_size, out.data_ptr(),
        scratch.data_ptr(), row_sum.data_ptr(), stream)
    _build.check(rc, "ceaz_chunk_dec_fused rows")
    carry = segment_carry(row_sum, seg0).to(torch.int32)
    rc = _build.function("ceaz_dec_add", _ADD_ARGS)(
        counts.data_ptr(), islor.data_ptr(), scratch.data_ptr(),
        carry.data_ptr(), C, NB, block_size, out.data_ptr(), stream)
    _build.check(rc, "ceaz_chunk_dec_fused add")
    return out


def ceaz_chunk_dec_cuda(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                        odelta2, base, seg0, islor, block_size: int):
    NB = nbits2.shape[1]
    if NB * block_size <= DEC_FUSE_LIMIT:
        return ceaz_chunk_dec_fused_cuda(words2, nbits2, counts, sym_flat,
                                         len_flat, cb_idx, odelta2, base,
                                         seg0, islor, block_size)
    codes = hufdec.hufdec_tiles_cuda(words2, nbits2, counts, sym_flat,
                                     len_flat, cb_idx, block_size)
    return patch_and_inverse(codes, counts, odelta2, base, seg0, islor)
