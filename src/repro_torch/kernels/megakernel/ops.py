"""The megakernel ops: `ceaz_chunk` (bank encode) and `ceaz_chunk_dec`.

Encode (the reference's ``src/repro/kernels/megakernel/ops.py:81``, with
``ref.py:100`` as its contract):

    ceaz_chunk(work2, prev2, valid2, ebs, bank_lengths, bank_cwords,
               block_size, w32, predictor)
      -> (q2, codes2, outl2, delta2, centers, hists, sel, totals, words,
          block_nbits)

work2 (C, cv) f32 chunk rows, prev2 (C, 1) f32 the RAW value before
each row (the Lorenzo halo; 0 for a stream head), valid2 (C, cv) bool
prefix masks, ebs (C,) f32, bank tables (K, 1024) int32 (codewords as
int32 holding u32 bits). q2/codes2/delta2 (C, cv) int32 and outl2 bool
are zero past the valid prefix; centers (C,) int32 (0 under Lorenzo);
hists (C, 1024) int32; sel the first-occurrence argmin_k of
hist . lengths_k and totals its payload bits, (C,) int32; words (C, w32)
int32 holding u32 bits and block_nbits (C, nblocks) the packed payload.
The reference's `cands` argument sizes its candidate window; the port's
pack places every symbol itself and has none.

The op is composed from three steps, each with a plain version
(``*_plain``, any device) and a CUDA wrapper (``*_cuda``, csrc/bank.cu,
csrc/center.cu and hufenc.cu):

  * quantize + histogram + bank select — :func:`lorenzo_bank_cuda`
    (Lorenzo from the one-value raw halo) or, on value rows,
    :func:`value_quant_cuda` -> ``dq_center`` (kernels/dualquant) ->
    :func:`value_bank_cuda`; one launch each, the select (argmin and
    the gathered book rows) folded into the quantize launch;
  * the `hufenc` gather-pack on the selected rows.

The `lorenzo_quant`, `value_finalize` and `bank_select` ops are the same
kernels with the select left out, or alone.

The reference switches at ``FUSE_ROW_LIMIT`` values per row from one
fused program per chunk (``kernel.py::ceaz_chunk_fused``) to word-tiled
kernels (``lorenzo_tiles``, ``value_quant_tiles``,
``value_finalize_tiles``). The port's kernels serve both regimes; each
quantize launch counts under the TPU kernel whose work it does at that
row length, so a run shows which regime it took.

Decode:

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
    (csrc/decode_fused.cu), walk + patch + inverse in one launch: the
    warp walk of kernels/hufdec, then each block's escape ranks and its
    segment prefix from two decoupled look-backs, q written once;
  * larger rows — the word-tiled walk kernel (kernels/hufdec) and the
    plain :func:`patch_and_inverse` tail on the card.

:func:`ceaz_chunk_dec_plain` is the plain PyTorch version of both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...core import dualquant as core_dq
from .. import _build
from .. import dispatch
from ..dualquant import ops as dq_ops
from ..hufdec import ops as hufdec
from ..hufenc import ops as hufenc

RADIUS = 512
NUM_SYMBOLS = 1024
FUSE_ROW_LIMIT = 1 << 17          # the reference's _FUSE_ROW_LIMIT
DEC_FUSE_LIMIT = 1 << 17
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_DEC_ARGS = [_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _I64, _P, _P, _P,
             _I64, _I64, _P, _P, _I64, _P, _P]
_SELECT_TAIL = [_P, _I64, _P, _P, _I64, _P, _P, _P, _P, _P]
_QUANT_ARGS = {
    "ceaz_bank_lorenzo": [_P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P]
    + _SELECT_TAIL,
    "ceaz_bank_value_finalize": [_P, _P, _P, _I64, _I64, _P, _P, _P, _P]
    + _SELECT_TAIL,
}
_VQ_ARGS = [_P, _P, _I64, _I64, _P, _P]
_SEL_ARGS = [_P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P]


# ---------------------------------------------------------------------------
# Encode: plain versions
# ---------------------------------------------------------------------------

def _row_hists(codes2: torch.Tensor, valid2: torch.Tensor) -> torch.Tensor:
    """(C, 1024) int32 histograms of each row's valid codes."""
    C = codes2.shape[0]
    rows = torch.arange(C, device=codes2.device)[:, None] * NUM_SYMBOLS
    keys = torch.where(valid2, rows + codes2.to(torch.int64),
                       C * NUM_SYMBOLS)              # padding: a spare bin
    hists = torch.bincount(keys.reshape(-1), minlength=C * NUM_SYMBOLS + 1)
    return hists[:C * NUM_SYMBOLS].reshape(C, NUM_SYMBOLS).to(torch.int32)


def _masked_post(q2, codes, outl, delta, valid2):
    """The reference's _postquant masking: zero past the valid prefix."""
    zero = torch.zeros((), dtype=torch.int32, device=q2.device)
    codes = torch.where(valid2, codes, zero)
    return (torch.where(valid2, q2, zero), codes, outl & valid2,
            torch.where(valid2, delta, zero), _row_hists(codes, valid2))


def lorenzo_quant_plain(work2, prev2, valid2, ebs):
    """-> (q2, codes2, outl2, delta2, hists): 1-D Lorenzo rows from the
    one-value raw halo prev2."""
    xr = torch.cat([prev2.reshape(-1, 1).to(torch.float32),
                    work2.to(torch.float32)], dim=1)
    qr = core_dq.prequantize(xr, ebs.reshape(-1, 1))
    q2 = qr[:, 1:]
    codes, outl, delta = core_dq.postquantize(q2, qr[:, :-1].to(torch.int64))
    return _masked_post(q2, codes, outl, delta, valid2)


def value_quant_plain(work2, ebs):
    """-> q2 (C, cv) int32, every entry prequantized (no mask)."""
    return core_dq.prequantize(work2, ebs.reshape(-1, 1))


def value_finalize_plain(q2, valid2, centers):
    """-> (q2 masked, codes2, outl2, delta2, hists) against each row's
    centre code."""
    codes, outl, delta = core_dq.value_postquantize(q2, centers[:, None])
    return _masked_post(q2.to(torch.int32), codes, outl, delta, valid2)


def bank_select_plain(hists, bank_lengths, bank_cwords):
    """-> (sel, totals, lengths_sel, cwords_sel): the first-occurrence
    argmin of the int32 costs hist . lengths_k and the selected rows."""
    costs = (hists.to(torch.int64)[:, None, :]
             * bank_lengths.to(torch.int64)[None, :, :]).sum(-1)
    costs = costs.to(torch.int32)           # the reference's int32 sums
    sel = torch.argmin(costs, dim=1)
    totals = torch.gather(costs, 1, sel[:, None])[:, 0]
    return (sel.to(torch.int32), totals, bank_lengths[sel].contiguous(),
            bank_cwords[sel].contiguous())


def lorenzo_bank_plain(work2, prev2, valid2, ebs, bank_lengths,
                       bank_cwords):
    """-> (q2, codes2, outl2, delta2, hists, sel, totals, lengths_sel,
    cwords_sel, centers): the Lorenzo quantize, then the select; centers
    (C,) zero."""
    enc = lorenzo_quant_plain(work2, prev2, valid2, ebs)
    centers = torch.zeros(work2.shape[0], dtype=torch.int32,
                          device=work2.device)
    return (*enc, *bank_select_plain(enc[4], bank_lengths, bank_cwords),
            centers)


def value_bank_plain(q2, valid2, centers, bank_lengths, bank_cwords):
    """-> (q2, codes2, outl2, delta2, hists, sel, totals, lengths_sel,
    cwords_sel): the value finalize, then the select."""
    enc = value_finalize_plain(q2, valid2, centers)
    return (*enc, *bank_select_plain(enc[4], bank_lengths, bank_cwords))


# ---------------------------------------------------------------------------
# Encode: CUDA wrappers (csrc/bank.cu)
# ---------------------------------------------------------------------------

def _regime(cv: int, tiled_name: str) -> str:
    """The TPU kernel a quantize launch stands in for at row length cv."""
    return "ceaz_chunk_fused" if cv <= FUSE_ROW_LIMIT else tiled_name


def _check_rows(name: str, t: torch.Tensor, dtype) -> None:
    if t.dtype != dtype or t.ndim != 2:
        raise ValueError(f"{name}: (C, cv) {dtype} rows expected, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _per_row(name: str, t: torch.Tensor, C: int, dtype) -> torch.Tensor:
    if t.dtype != dtype or t.numel() != C:
        raise ValueError(f"{name}: one {dtype} value per row expected")
    return t.reshape(C).contiguous()


def _check_bank(name, bank_lengths, bank_cwords) -> int:
    """K of the (K, 1024) int32 bank tables."""
    K = bank_lengths.shape[0]
    for what, t in (("bank_lengths", bank_lengths),
                    ("bank_cwords", bank_cwords)):
        if t.dtype != torch.int32 or t.ndim != 2 \
                or t.shape[1] != NUM_SYMBOLS:
            raise ValueError(f"{name}: {what} (*, {NUM_SYMBOLS}) int32 "
                             "expected")
    if bank_cwords.shape[0] != K or K == 0:
        raise ValueError(f"{name}: bank tables (K, 1024), K >= 1")
    return K


def _select_outs(C: int, dev):
    """sel, totals (C,) and the selected rows (C, 1024), int32."""
    return (torch.empty(C, dtype=torch.int32, device=dev),
            torch.empty(C, dtype=torch.int32, device=dev),
            torch.empty((C, NUM_SYMBOLS), dtype=torch.int32, device=dev),
            torch.empty((C, NUM_SYMBOLS), dtype=torch.int32, device=dev))


def _quant_select_cuda(name: str, entry: str, ins, C: int, cv: int, dev,
                       bank):
    """One quantize launch of csrc/bank.cu in Lorenzo or finalize mode
    (`ins`: its input pointers), with the select folded in when `bank`
    (the two tables) is given. Its one memset zeroes a single int32
    buffer: the histograms (C, 1024), then with the bank the tickets (C,)
    and C zero words (the Lorenzo op's centres).
    -> (q2, codes2, outl2, delta2, hists[, sel, totals, ln_sel, cw_sel,
    zero centres])."""
    q2, codes2, delta2 = (torch.empty((C, cv), dtype=torch.int32, device=dev)
                          for _ in range(3))
    outl2 = torch.empty((C, cv), dtype=torch.bool, device=dev)
    tail = 2 if bank is not None else 0
    zeroed = torch.empty(C * (NUM_SYMBOLS + tail), dtype=torch.int32,
                         device=dev)
    hists = zeroed[:C * NUM_SYMBOLS].view(C, NUM_SYMBOLS)
    sel_outs = ()
    K, tables = 0, (None, None)
    if bank is not None:
        K = _check_bank(name, *bank)
        bank = tuple(t.contiguous() for t in bank)
        tables = tuple(t.data_ptr() for t in bank)
        sel_outs = _select_outs(C, dev) + (zeroed[C * (NUM_SYMBOLS + 1):],)
    dispatch.count_launch(name)
    rc = _build.function(entry, _QUANT_ARGS[entry])(
        *ins, C, cv, q2.data_ptr(), codes2.data_ptr(), outl2.data_ptr(),
        delta2.data_ptr(), zeroed.data_ptr(), 4 * zeroed.numel(), *tables, K,
        *(t.data_ptr() for t in sel_outs[:4]) if sel_outs else (None,) * 4,
        dispatch.stream_handle())
    _build.check(rc, name)
    return (q2, codes2, outl2, delta2, hists, *sel_outs)


def _lorenzo_cuda(work2, prev2, valid2, ebs, bank):
    dispatch.require_cuda("lorenzo_quant", work2, valid2)
    _check_rows("lorenzo_quant", work2, torch.float32)
    C, cv = work2.shape
    if valid2.shape != (C, cv) or valid2.dtype != torch.bool:
        raise ValueError("lorenzo_quant: valid2 (C, cv) bool expected")
    prev = _per_row("lorenzo_quant prev2", prev2, C, torch.float32)
    eb = _per_row("lorenzo_quant ebs", ebs, C, torch.float32)
    dispatch.require_cuda("lorenzo_quant", prev, eb)
    work2, valid2 = work2.contiguous(), valid2.contiguous()
    return _quant_select_cuda(
        _regime(cv, "lorenzo_tiles"), "ceaz_bank_lorenzo",
        (work2.data_ptr(), prev.data_ptr(), valid2.data_ptr(), eb.data_ptr()),
        C, cv, work2.device, bank)


def lorenzo_quant_cuda(work2, prev2, valid2, ebs):
    """-> (q2, codes2, outl2, delta2, hists): the Lorenzo quantize alone."""
    return _lorenzo_cuda(work2, prev2, valid2, ebs, None)[:5]


def lorenzo_bank_cuda(work2, prev2, valid2, ebs, bank_lengths, bank_cwords):
    """lorenzo_bank_plain in one launch (the select folded in); the zero
    centres come from the launch's zeroed buffer."""
    dispatch.require_cuda("lorenzo_quant", bank_lengths, bank_cwords)
    return _lorenzo_cuda(work2, prev2, valid2, ebs,
                         (bank_lengths, bank_cwords))


def value_quant_cuda(work2, ebs):
    dispatch.require_cuda("value_quant", work2)
    _check_rows("value_quant", work2, torch.float32)
    C, cv = work2.shape
    eb = _per_row("value_quant ebs", ebs, C, torch.float32)
    dispatch.require_cuda("value_quant", eb)
    work2 = work2.contiguous()
    q2 = torch.empty((C, cv), dtype=torch.int32, device=work2.device)
    name = _regime(cv, "value_quant_tiles")
    dispatch.count_launch(name)
    rc = _build.function("ceaz_bank_value_quant", _VQ_ARGS)(
        work2.data_ptr(), eb.data_ptr(), C, cv, q2.data_ptr(),
        dispatch.stream_handle())
    _build.check(rc, name)
    return q2


def _finalize_cuda(q2, valid2, centers, bank):
    dispatch.require_cuda("value_finalize", q2, valid2)
    _check_rows("value_finalize", q2, torch.int32)
    C, cv = q2.shape
    if valid2.shape != (C, cv) or valid2.dtype != torch.bool:
        raise ValueError("value_finalize: valid2 (C, cv) bool expected")
    ctr = _per_row("value_finalize centers", centers, C, torch.int32)
    dispatch.require_cuda("value_finalize", ctr)
    q2, valid2 = q2.contiguous(), valid2.contiguous()
    return _quant_select_cuda(
        _regime(cv, "value_finalize_tiles"), "ceaz_bank_value_finalize",
        (q2.data_ptr(), valid2.data_ptr(), ctr.data_ptr()), C, cv, q2.device,
        bank)


def value_finalize_cuda(q2, valid2, centers):
    """-> (q2 masked, codes2, outl2, delta2, hists)."""
    return _finalize_cuda(q2, valid2, centers, None)[:5]


def value_bank_cuda(q2, valid2, centers, bank_lengths, bank_cwords):
    """value_bank_plain in one launch (the select folded in)."""
    dispatch.require_cuda("value_finalize", bank_lengths, bank_cwords)
    return _finalize_cuda(q2, valid2, centers,
                          (bank_lengths, bank_cwords))[:9]


def bank_select_cuda(hists, bank_lengths, bank_cwords):
    dispatch.require_cuda("bank_select", hists, bank_lengths, bank_cwords)
    K = _check_bank("bank_select", bank_lengths, bank_cwords)
    if hists.dtype != torch.int32 or hists.ndim != 2 \
            or hists.shape[1] != NUM_SYMBOLS:
        raise ValueError(f"bank_select: hists (*, {NUM_SYMBOLS}) int32 "
                         "expected")
    hists, bank_lengths, bank_cwords = (
        t.contiguous() for t in (hists, bank_lengths, bank_cwords))
    C = hists.shape[0]
    sel, totals, ln_sel, cw_sel = _select_outs(C, hists.device)
    dispatch.count_launch("bank_select")
    rc = _build.function("ceaz_bank_select", _SEL_ARGS)(
        hists.data_ptr(), bank_lengths.data_ptr(), bank_cwords.data_ptr(), C,
        K, sel.data_ptr(), totals.data_ptr(), ln_sel.data_ptr(),
        cw_sel.data_ptr(), dispatch.stream_handle())
    _build.check(rc, "bank_select")
    return sel, totals, ln_sel, cw_sel


# ---------------------------------------------------------------------------
# Encode: the composed op
# ---------------------------------------------------------------------------

def _ceaz_chunk(steps, work2, prev2, valid2, ebs, bank_lengths, bank_cwords,
                block_size: int, w32: int, predictor: str):
    lorenzo, vquant, center, vbank, pack = steps
    if predictor == "lorenzo":
        *enc, centers = lorenzo(work2, prev2, valid2, ebs, bank_lengths,
                                bank_cwords)
    elif predictor == "value":
        q2 = vquant(work2, ebs)
        centers = center(q2, valid2)
        enc = vbank(q2, valid2, centers, bank_lengths, bank_cwords)
    else:
        raise ValueError(f"ceaz_chunk: predictor must be 'lorenzo' or "
                         f"'value', got {predictor!r}")
    q2, codes2, outl2, delta2, hists, sel, totals, ln_sel, cw_sel = enc
    words, block_nbits = pack(codes2, valid2, ln_sel, cw_sel, block_size, w32)
    return (q2, codes2, outl2, delta2, centers, hists, sel, totals, words,
            block_nbits)


def ceaz_chunk_plain(work2, prev2, valid2, ebs, bank_lengths, bank_cwords,
                     block_size: int, w32: int, predictor: str = "lorenzo"):
    """Plain PyTorch version of the op (any device)."""
    return _ceaz_chunk(
        (lorenzo_bank_plain, value_quant_plain, dq_ops.chunk_center_plain,
         value_bank_plain, hufenc.encode_pack_plain),
        work2, prev2, valid2, ebs, bank_lengths, bank_cwords, block_size,
        w32, predictor)


def ceaz_chunk_cuda(work2, prev2, valid2, ebs, bank_lengths, bank_cwords,
                    block_size: int, w32: int, predictor: str = "lorenzo"):
    """The op on the card: csrc/bank.cu's quantize-and-select launch
    (after value_quant and center.cu on value rows), then hufenc.cu's
    pack."""
    return _ceaz_chunk(
        (lorenzo_bank_cuda, value_quant_cuda, dq_ops.dq_center_cuda,
         value_bank_cuda, hufenc.encode_pack_cuda),
        work2, prev2, valid2, ebs, bank_lengths, bank_cwords, block_size,
        w32, predictor)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


# values a row slice of patch_and_inverse holds: its int64 temporaries
# stay a few of 2^25 x 8 B, where a restore group of 512 rows of 2^20
# would otherwise hold ten of 4 GB at once
TAIL_VALUES = 1 << 25


def patch_and_inverse(codes2, counts, odelta2, base, seg0, islor):
    """codes -> reconstruction codes q (plain PyTorch, any device); the
    reference's ``ref.patch_and_inverse``, with the prefix sums taken in
    int64 and wrapped once at the end (same residues mod 2^32). Rows go
    in slices of about TAIL_VALUES values, in order, the segment carry
    running on across them: carry[c] = sum(row_sum[seg0[c]:c]), which
    needs the contract's seg0[c] in [0, c]."""
    C, N = codes2.shape
    dev = codes2.device
    Ko = odelta2.shape[1]
    pos = torch.arange(N, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    seg0 = seg0.to(torch.int64)
    carry_all = torch.zeros(C, dtype=torch.int64, device=dev)  # exclusive
    total = zero
    out = torch.empty((C, N), dtype=torch.int32, device=dev)
    step = max(1, TAIL_VALUES // max(N, 1))
    for r0 in range(0, C, step):
        rows = slice(r0, min(C, r0 + step))
        codes = codes2[rows].to(torch.int64)
        valid = pos[None, :] < counts[rows].to(torch.int64)[:, None]
        is_out = valid & (codes == 0)
        io = is_out.to(torch.int64)
        rank = torch.cumsum(io, 1) - io             # exclusive zero-count
        dval = torch.gather(odelta2[rows].to(torch.int64), 1,
                            rank.clamp(0, Ko - 1))
        delta = torch.where(is_out, dval, codes - RADIUS)
        del codes, is_out, io, rank, dval
        delta = torch.where(valid, delta, zero)
        local = torch.cumsum(delta, 1)
        dsum = local[:, -1]
        inc = torch.cumsum(dsum, 0)
        carry_all[rows] = total + inc - dsum
        total = total + inc[-1]
        carry = carry_all[rows] - carry_all[seg0[rows]]
        q = torch.where(islor[rows].to(torch.bool)[:, None],
                        local + carry[:, None],
                        delta + base[rows].to(torch.int64)[:, None])
        del local, delta
        out[rows] = torch.where(valid, q, zero)
    return out


def ceaz_chunk_dec_plain(words2, nbits2, counts, sym_flat, len_flat, cb_idx,
                         odelta2, base, seg0, islor, block_size: int):
    """The op in plain PyTorch (any device). Its contract has seg0[c] in
    [0, c], as :func:`patch_and_inverse` needs; the fused kernel clamps
    seg0[c] into [0, c]."""
    C, W = words2.shape
    NB = nbits2.shape[1]
    if NB * block_size <= DEC_FUSE_LIMIT:
        codes = hufdec.walk_plain(words2, nbits2, counts, sym_flat, len_flat,
                                  cb_idx, block_size, NB, W)
    else:
        codes = hufdec.hufdec_tiles_plain(words2, nbits2, counts, sym_flat,
                                          len_flat, cb_idx, block_size)
    return patch_and_inverse(codes, counts, odelta2, base, seg0, islor)


@functools.lru_cache(maxsize=256)
def dec_fused_scratch_bytes(C: int, NB: int) -> int:
    """Bytes of the look-back scratch of a fused decode launch over C rows
    of NB blocks, from the built kernel library (csrc/decode_fused.cu owns
    its layout)."""
    fn = _build.function("ceaz_dec_fused_scratch_bytes", [_I64, _I64])
    fn.restype = _I64
    return fn(C, NB)


def ceaz_chunk_dec_fused_cuda(words2, nbits2, counts, sym_flat, len_flat,
                              cb_idx, odelta2, base, seg0, islor,
                              block_size: int) -> torch.Tensor:
    """csrc/decode_fused.cu: one launch (after the table packer), any row
    count. seg0[c] must lie in [0, c] (a segment's rows are contiguous
    and ascending)."""
    args = (words2, nbits2, counts, sym_flat, len_flat, cb_idx, odelta2,
            base, seg0, islor)
    dispatch.require_cuda("ceaz_chunk_dec_fused", *args)
    C, W = words2.shape
    NB = nbits2.shape[1]
    Ko = odelta2.shape[1]
    if words2.dtype != torch.int32 or odelta2.dtype != torch.int32:
        raise ValueError("ceaz_chunk_dec_fused: words2/odelta2 must be int32")
    if W < 2 or Ko < 1:
        raise ValueError("ceaz_chunk_dec_fused: at least 2 words and one "
                         "outlier slot a row")
    dev = words2.device
    i32 = lambda t: t.to(torch.int32).contiguous()
    words2, nbits2, counts, cb_idx, odelta2, base, seg0, islor = map(
        i32, (words2, nbits2, counts, cb_idx, odelta2, base, seg0, islor))
    t32, t16, check = hufdec.pack_tables_cuda("ceaz_chunk_dec_fused",
                                              sym_flat, len_flat)
    out = torch.empty((C, NB * block_size), dtype=torch.int32, device=dev)
    nbytes = dec_fused_scratch_bytes(C, NB)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dispatch.count_launch("ceaz_chunk_dec_fused")
    try:
        rc = _build.function("ceaz_dec_fused", _DEC_ARGS)(
            words2.data_ptr(), C, W, nbits2.data_ptr(), counts.data_ptr(),
            t32.data_ptr(), t16.data_ptr(), cb_idx.data_ptr(),
            odelta2.data_ptr(), Ko, base.data_ptr(), seg0.data_ptr(),
            islor.data_ptr(), NB, block_size, out.data_ptr(),
            scratch.data_ptr(), nbytes,
            hufdec.stats_tensor("ceaz_chunk_dec_fused", dev).data_ptr(),
            dispatch.stream_handle())
        _build.check(rc, "ceaz_chunk_dec_fused")
    finally:
        check()
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
