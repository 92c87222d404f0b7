"""Fused CEAZ encode: the exact two-pass route and the single-pass bank
route, abs/rel, Lorenzo or value-direct prediction, fixed-ratio mode on
either coder, and batches of same-shape shards.

Port of the reference's ``runtime/fused.py::compress_error_bounded``,
``compress_error_bounded_bank``, ``compress_fixed_ratio`` and
``batch_compress`` on torch tensors. The exact route:

  pass 1  — the `dualquant` op quantizes the WHOLE array (native-rank
            global Lorenzo) into the chunked layout and yields the
            prequantized field q the literal check replays; per-chunk
            histograms (on the card the `histogram` op, with the literal
            candidates) are the only summaries that reach the host.
  host    — the chi / codebook policy (AdaptiveCoder) on the histograms.
  pass 2  — the `hufenc` op gather-packs every chunk against its own
            codebook; payload words and block bit counts come back in one
            transfer each.

Bit-exactness contract: for the same input the result is bit-identical
to the reference's ``CEAZ(use_fused=True)`` in every CEAZCompressed
field (tests/test_torch_ceaz.py). The payload is packed in u32 words
(int32 storage) and folded into the u64 wire words on the host.

Value-direct prediction (``predictor='none'``) replaces the Lorenzo
pass 1 with three ops over the chunk rows: `value_quant`, the
`dq_center` median of each row and `value_finalize` against it; the
integer field the literal check replays is q itself.

The bank route (:func:`compress_error_bounded_bank`) picks each chunk's
codebook from an offline CodebookBank on the device: quantize ->
histogram -> select -> pack with no host step between, then the host
replays the selection from the histograms (asserting it picked the
same book) and re-packs only when a chunk outgrew the provisioned
payload.

Fixed-ratio mode (:func:`compress_fixed_ratio`) treats the array as a
1-D stream of chunks whose bound follows the rate controller. Windows
of full chunks are quantized in one launch at forecast bounds (each row
an independent stream with a zero halo: the `lorenzo_quant` step, or
the whole `ceaz_chunk` op for the bank coder), the exact feedback chain
is replayed on the host from the histograms, and a mispredicted chunk
is requantized alone, so the stream equals the sequential loop's.

Stats branches, as the reference: on a CPU device the summaries come
from one host snapshot (numpy bincount / flatnonzero at memory speed);
on the card histograms and the sparse compactions (outliers, literal
candidates) run as device ops, and the host replays the float64 literal
formula on the candidates only. Eager PyTorch has dynamic shapes, so
the compactions need no fixed capacity and no overflow fallback.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import dualquant as core_dq
from ..core.codebook import (DEFAULT_TAU0, DEFAULT_TAU1, AdaptiveCoder,
                             AdaptiveDecision, BankCoder)
from ..core.huffman import DEFAULT_MAX_LEN, NUM_SYMBOLS, Codebook
from ..kernels import dispatch
from ..kernels.hufenc.ops import u32_to_u64
from ..obs import metrics as om
from ..obs import trace as ot

# The wire format assumes codes never exceed 16 bits.
MAX_CODE_BITS = DEFAULT_MAX_LEN
_EPS32 = float(np.finfo(np.float32).eps)


def target_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is present; pass "
            "device='cpu' to run the plain PyTorch versions")
    return dev


def chunk_layout(n: int, chunk_values: int) -> Tuple[int, int]:
    """(n_chunks, n_last) for an n-value stream cut into chunk_values."""
    n_chunks = max(1, -(-n // chunk_values))
    n_last = n - (n_chunks - 1) * chunk_values
    return n_chunks, n_last


def words_capacity(chunk_values: int) -> int:
    """u32 words per chunk at MAX_CODE_BITS/value, rounded so the valid
    prefix always trims to whole u64 words."""
    max_w64 = (chunk_values * MAX_CODE_BITS + 63) // 64
    return 2 * (max_w64 + 1)


def _w32_bucket(totals: np.ndarray, chunk_values: int) -> int:
    """Bucketed u32 capacity covering the exact payload bits: powers of
    two up to a page, then page multiples."""
    need = 2 * ((int(totals.max()) + 63) // 64 + 1)
    cap = words_capacity(chunk_values)
    if need <= 4096:
        w32 = 4
        while w32 < need:
            w32 *= 2
    else:
        w32 = -(-need // 4096) * 4096
    return min(w32, cap)


# ---------------------------------------------------------------------------
# Pass 1
# ---------------------------------------------------------------------------

def _quantize_pass(work: torch.Tensor, eb: float, ndim: int, n_chunks: int,
                   chunk_values: int, kernel_impl: str):
    """work (f32, rank=ndim) -> (codes2, outl2, delta2, valid2, q):
    (n_chunks, chunk_values) rows and the flat prequantized field."""
    n = work.numel()
    n_out = n_chunks * chunk_values
    dq = dispatch.resolve("dualquant", kernel_impl, work.device)
    with dispatch.measure("dualquant", kernel_impl, work.device):
        codes, outl, delta, q = dq(work, eb, ndim, n_out)
    valid = torch.arange(n_out, device=work.device) < n
    shape = (n_chunks, chunk_values)
    return (codes.reshape(shape), outl.reshape(shape),
            delta.reshape(shape), valid.reshape(shape), q)


def _extract_sparse(mask: torch.Tensor, values: torch.Tensor):
    """(ascending positions, values there) of a flat mask."""
    idx = torch.nonzero(mask).reshape(-1)
    return idx, values[idx]


def _chunk_hists(codes2, valid2, kernel_impl: str) -> torch.Tensor:
    """Per-chunk histograms of the valid codes: the `histogram` op."""
    dev = codes2.device
    hist = dispatch.resolve("histogram", kernel_impl, dev)
    with dispatch.measure("histogram", kernel_impl, dev):
        return hist(codes2, valid2)


def _literal_candidates(q, work, eb32):
    """Card path: literal candidates as device ops, -> (flat positions,
    q there). q and work share a shape; eb32 is the f32 bound, one
    scalar or one per row ((rows, 1) against (rows, cv) fields).

    The decompressor reconstructs through a float64 multiply; here only
    the float32 formula runs, so a conservative CANDIDATE set (few-ulp
    guard band) is collected with the exact integer q at each candidate
    — the host replays the float64 formula on just those.
    """
    dev = q.device
    rec = q.to(torch.float32) * (eb32 * 2.0)
    margin = (core_dq.f32_scalar(16.0 * _EPS32, dev)
              * (rec.abs() + work.abs())
              + core_dq.f32_scalar(1e-38, dev))
    cand = (rec - work).abs() > (eb32 - margin)
    return _extract_sparse(cand.reshape(-1), q.reshape(-1))


@dataclasses.dataclass
class _Pass1:
    """State between the two passes. The chunked rows stay on the
    device; which summaries exist depends on the stats branch."""
    codes2: torch.Tensor
    outl2: torch.Tensor
    delta2: torch.Tensor
    valid2: torch.Tensor
    q: torch.Tensor
    hists: np.ndarray
    n: int
    n_chunks: int
    chunk_values: int
    stats_on_device: bool
    # device-stats branch: literal candidates
    lit_idx: Optional[torch.Tensor] = None
    lit_q: Optional[torch.Tensor] = None
    # host-stats branch: snapshot of q
    q_host: Optional[np.ndarray] = None
    # value-direct (predictor='none'): per-chunk centre codes
    predictor: str = "lorenzo"
    centers: Optional[np.ndarray] = None


def _host_hists(codes_host: np.ndarray, n: int) -> np.ndarray:
    """Per-chunk histograms in ONE bincount pass."""
    nc, cv = codes_host.shape
    flat = codes_host.reshape(-1)[:n].astype(np.int64)
    keys = flat + (np.arange(n, dtype=np.int64) // cv) * NUM_SYMBOLS
    return np.bincount(keys, minlength=nc * NUM_SYMBOLS) \
        .reshape(nc, NUM_SYMBOLS)


def _finish_pass1(codes2, outl2, delta2, valid2, q, work, eb,
                  chunk_values: int, stats_on_device: bool, hists=None,
                  predictor: str = "lorenzo", centers=None) -> _Pass1:
    """The summaries of either stats branch around one pass 1.

    q and work are the flat stream, or (rows, cv) chunk rows with `eb` a
    (rows, 1) f32 tensor of per-row bounds (a fixed-ratio window);
    `hists`, when the pass or the device-stats branch produced them, is
    a tensor or an array (else the host snapshot counts them)."""
    n = q.numel()
    if hists is None:
        hists = _host_hists(codes2.cpu().numpy(), n)
    if isinstance(hists, torch.Tensor):
        hists = hists.cpu().numpy()
    p1 = _Pass1(codes2, outl2, delta2, valid2, q, hists.astype(np.int64),
                n, codes2.shape[0], chunk_values, stats_on_device,
                predictor=predictor,
                centers=(None if centers is None
                         else centers.cpu().numpy().astype(np.int64)))
    if stats_on_device:
        eb32 = (eb if isinstance(eb, torch.Tensor)
                else core_dq.f32_scalar(eb, q.device))
        p1.lit_idx, p1.lit_q = _literal_candidates(q, work, eb32)
    else:
        p1.q_host = q.reshape(-1).cpu().numpy()
    return p1


def _run_pass1(work: torch.Tensor, eb: float, ndim: int, chunk_values: int,
               stats_on_device: Optional[bool], kernel_impl: str) -> _Pass1:
    if stats_on_device is None:
        stats_on_device = work.device.type != "cpu"
    n_chunks, _ = chunk_layout(work.numel(), chunk_values)
    codes2, outl2, delta2, valid2, q = _quantize_pass(
        work, eb, ndim, n_chunks, chunk_values, kernel_impl)
    hists = (_chunk_hists(codes2, valid2, kernel_impl) if stats_on_device
             else None)
    return _finish_pass1(codes2, outl2, delta2, valid2, q, work.reshape(-1),
                         eb, chunk_values, stats_on_device, hists=hists)


def _chunk_rows(flat: torch.Tensor, n_chunks: int, chunk_values: int):
    """A flat f32 stream as zero-padded (n_chunks, chunk_values) rows and
    their prefix-valid mask."""
    n = flat.numel()
    n_out = n_chunks * chunk_values
    work2 = torch.nn.functional.pad(flat, (0, n_out - n)) \
        .reshape(n_chunks, chunk_values)
    valid2 = (torch.arange(n_out, device=flat.device) < n) \
        .reshape(n_chunks, chunk_values)
    return work2, valid2


def _row_ebs(ebs, device) -> torch.Tensor:
    """One f32 bound per chunk row from python floats, each rounded once
    (the reference traces eb as f32: ``jnp.asarray(ebs, jnp.float32)``)."""
    return torch.tensor(ebs, dtype=torch.float32, device=device)


def _value_rows(work2: torch.Tensor, valid2: torch.Tensor, ebs,
                kernel_impl: str):
    """Value-direct pass 1 over chunk rows at one f32 bound each:
    quantize, centre each row on its median, code against the centre.
    -> (q2, codes2, outl2, delta2, centers, hists)."""
    dev = work2.device
    vquant, center, vfinal = (
        dispatch.resolve(op, kernel_impl, dev)
        for op in ("value_quant", "dq_center", "value_finalize"))
    with dispatch.measure("value_quant", kernel_impl, dev):
        q2 = vquant(work2, ebs)
    with dispatch.measure("dq_center", kernel_impl, dev):
        centers = center(q2, valid2)
    with dispatch.measure("value_finalize", kernel_impl, dev):
        q2, codes2, outl2, delta2, hists = vfinal(q2, valid2, centers)
    return q2, codes2, outl2, delta2, centers, hists


def _value_pass(flat: torch.Tensor, eb: float, n_chunks: int,
                chunk_values: int, kernel_impl: str):
    """Value-direct pass 1 over the chunk rows of one flat stream.
    -> (q2, codes2, outl2, delta2, valid2, centers, hists)."""
    work2, valid2 = _chunk_rows(flat, n_chunks, chunk_values)
    q2, codes2, outl2, delta2, centers, hists = _value_rows(
        work2, valid2, _row_ebs([eb] * n_chunks, flat.device), kernel_impl)
    return q2, codes2, outl2, delta2, valid2, centers, hists


def _run_value_pass1(work: torch.Tensor, eb: float, chunk_values: int,
                     stats_on_device: Optional[bool] = None,
                     kernel_impl: str = "auto") -> _Pass1:
    """Value-direct twin of :func:`_run_pass1`: the same _Pass1 contract
    with per-chunk centre codes instead of Lorenzo prediction. The
    integer field the literal check replays is q itself (the
    reconstruction is q * 2eb, no prefix sum)."""
    if stats_on_device is None:
        stats_on_device = work.device.type != "cpu"
    flat = work.reshape(-1)
    n = flat.numel()
    n_chunks, _ = chunk_layout(n, chunk_values)
    q2, codes2, outl2, delta2, valid2, centers, hists = _value_pass(
        flat, eb, n_chunks, chunk_values, kernel_impl)
    return _finish_pass1(codes2, outl2, delta2, valid2, q2.reshape(-1)[:n],
                         flat, eb, chunk_values, stats_on_device,
                         hists=hists, predictor="none", centers=centers)


# ---------------------------------------------------------------------------
# Host side and pass 2
# ---------------------------------------------------------------------------

def _literals(p1: _Pass1, x_flat: np.ndarray, eb
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact literal set (identical to the staged float64 check): the
    reconstruction is rounded through the ORIGINAL dtype and compared
    with the caller's original values — densely on the host snapshot,
    or on the device's candidates only. `eb` is the float64 bound, or a
    list of one bound per chunk row."""
    out_dtype = x_flat.dtype
    if p1.stats_on_device:
        idx = p1.lit_idx.cpu().numpy().astype(np.int64)
        q = p1.lit_q.cpu().numpy().astype(np.int64)
        x_c = x_flat[idx]
    else:
        idx = None
        q = p1.q_host.astype(np.int64)
        x_c = x_flat
    if isinstance(eb, (list, np.ndarray)):
        pos = np.arange(len(q)) if idx is None else idx
        eb = np.asarray(eb, np.float64)[pos // p1.chunk_values]
    rec = (q.astype(np.float64) * (2.0 * eb)).astype(out_dtype)
    viol = np.flatnonzero(
        np.abs(rec.astype(np.float64) - x_c.astype(np.float64)) > eb)
    viol = viol if idx is None else idx[viol]
    viol = viol.astype(np.int64)
    return viol, x_flat[viol].copy()


def _chunk_len(p1: _Pass1, i: int) -> int:
    return (p1.chunk_values if i < p1.n_chunks - 1
            else p1.n - (p1.n_chunks - 1) * p1.chunk_values)


def _outliers(p1: _Pass1) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-chunk (idx, delta) outlier escapes, chunk-local positions in
    ascending order."""
    mask = p1.outl2 & p1.valid2
    if p1.stats_on_device:
        nz = torch.nonzero(mask)
        rows = nz[:, 0].cpu().numpy()
        cols = nz[:, 1].cpu().numpy().astype(np.int64)
        deltas = p1.delta2[nz[:, 0], nz[:, 1]].cpu().numpy()
        cuts = np.searchsorted(rows, np.arange(1, p1.n_chunks))
        return [(oi, od.astype(np.int32)) for oi, od in
                zip(np.split(cols, cuts), np.split(deltas, cuts))]
    mask_h = mask.cpu().numpy()
    delta_h = p1.delta2.cpu().numpy()
    out = []
    for i in range(p1.n_chunks):
        oi = np.flatnonzero(mask_h[i]).astype(np.int64)
        out.append((oi, delta_h[i][oi].astype(np.int32)))
    return out


def _codebook_tables(decisions) -> Tuple[np.ndarray, np.ndarray]:
    lengths = np.stack([d.codebook.lengths for d in decisions]) \
        .astype(np.int32)
    cwords = np.stack([d.codebook.codes for d in decisions]) \
        .astype(np.int32)
    return lengths, cwords


def _encode_rows(hists: np.ndarray, codes2, valid2, chunk_values: int,
                 decisions, block_size: int, kernel_impl: str):
    """Pass 2: provision the pack for the exact bit-rate (per-chunk
    payload is hist . lengths, free on the host) and run the gather-pack
    op. Returns (words u32 numpy, block_nbits numpy, totals)."""
    lengths_np, cwords_np = _codebook_tables(decisions)
    totals = np.einsum("cs,cs->c", hists.astype(np.int64),
                       lengths_np.astype(np.int64))
    w32 = _w32_bucket(totals, chunk_values)
    dev = codes2.device
    encode_pack = dispatch.resolve("hufenc", kernel_impl, dev)
    with dispatch.measure("hufenc", kernel_impl, dev):
        words, block_nbits = encode_pack(
            codes2, valid2, torch.from_numpy(lengths_np).to(dev),
            torch.from_numpy(cwords_np).to(dev), block_size, w32)
    return (words.cpu().numpy().view(np.uint32), block_nbits.cpu().numpy(),
            totals)


def _assemble_chunks(p1: _Pass1, words_np, nbits_np, totals, outliers,
                     eb, decisions, block_size: int) -> List:
    """Host CompressedChunk records from the batched transfers; `eb` is
    the bound of every chunk, or a list of one bound per chunk."""
    from ..core.ceaz import CompressedChunk
    ebs = eb if isinstance(eb, list) else [eb] * len(decisions)
    chunks = []
    for i, decision in enumerate(decisions):
        n_i = _chunk_len(p1, i)
        nw64 = (int(totals[i]) + 63) // 64
        words = u32_to_u64(words_np[i, :2 * (nw64 + 1)])
        nblocks = max(1, -(-n_i // block_size))
        oi, od = outliers[i]
        chunks.append(CompressedChunk(
            words=words, block_nbits=nbits_np[i, :nblocks].astype(np.int64),
            n_values=n_i, eb=ebs[i],
            action=decision.action, chi=decision.chi,
            codebook_lengths=(decision.codebook.lengths.copy()
                              if decision.stored_codebook else None),
            codebook_id=decision.codebook.id,
            outlier_idx=oi, outlier_delta=od,
            center=(int(p1.centers[i]) if p1.centers is not None else 0),
            bank_ref=decision.bank_ref, bank_index=decision.bank_index))
    return chunks


def _policy(hists: np.ndarray, coder: AdaptiveCoder, adaptive: bool,
            exact_build: bool):
    """Host chi policy over the per-chunk histogram summaries (a bank
    coder always steps: it selects, it never rebuilds)."""
    decisions = []
    for freqs in hists.astype(np.int64):
        if isinstance(coder, BankCoder) or adaptive:
            decisions.append(coder.step(freqs))
        else:
            cb = Codebook.from_freqs(freqs, exact=exact_build)
            decisions.append(AdaptiveDecision("rebuild", 0.0, cb, True))
    return decisions


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _work(x: np.ndarray, predictor: str, device):
    """(work f32 tensor on device, ndim): the flat stream for
    value-direct, the native-rank field (rank <= 3) for Lorenzo. Float64
    input quantizes through its f32 cast; the literal channel restores
    the float64 bound."""
    if predictor == "none":
        ndim, shape = 1, (-1,)
    elif predictor == "lorenzo":
        ndim = min(x.ndim, 3)
        shape = x.shape if x.ndim <= 3 else (-1,) + x.shape[-2:]
    else:
        raise ValueError(f"unknown predictor {predictor!r}")
    work = torch.from_numpy(np.ascontiguousarray(
        x.reshape(shape), dtype=np.float32)).to(device)
    return work, ndim


def compress_error_bounded(x: np.ndarray, eb: float, mode: str,
                           coder: AdaptiveCoder, chunk_values: int,
                           block_size: int, device="cuda",
                           adaptive: bool = True, exact_build: bool = False,
                           stats_on_device: Optional[bool] = None,
                           kernel_impl: str = "auto",
                           predictor: str = "lorenzo"):
    """Fused abs/rel compression of a float32/float64 array on `device`
    (the card unless the caller asks for the CPU).

    Lorenzo: the array is quantized ONCE (native-rank Lorenzo) and the
    code stream is cut into chunks for the adaptive coder; value-direct
    (``predictor='none'``) codes each value against its chunk's median
    code. Returns a CEAZCompressed.
    """
    from ..core.ceaz import CEAZCompressed
    dev = target_device(device)
    # capping at the stream length keeps chunk boundaries identical and
    # avoids padding the pipeline up to a chunk nothing fills
    chunk_values = max(1, min(chunk_values, int(x.size)))
    work, ndim = _work(x, predictor, dev)
    if predictor == "none":
        p1 = _run_value_pass1(work, eb, chunk_values, stats_on_device,
                              kernel_impl)
    else:
        p1 = _run_pass1(work, eb, ndim, chunk_values, stats_on_device,
                        kernel_impl)
    decisions = _policy(p1.hists, coder, adaptive, exact_build)
    with ot.span("fused.encode_pass2", n_chunks=p1.n_chunks):
        words_np, nbits_np, totals = _encode_rows(
            p1.hists, p1.codes2, p1.valid2, p1.chunk_values, decisions,
            block_size, kernel_impl)
        outliers = _outliers(p1)
    chunks = _assemble_chunks(p1, words_np, nbits_np, totals, outliers, eb,
                              decisions, block_size)
    lit_idx, lit_val = _literals(p1, x.reshape(-1), eb)
    return CEAZCompressed(shape=x.shape, dtype=str(x.dtype), ndim=ndim,
                          mode=mode, chunks=chunks,
                          word_bits=x.dtype.itemsize * 8,
                          predictor=predictor,
                          literal_idx=lit_idx, literal_val=lit_val)


# ---------------------------------------------------------------------------
# Single-pass bank mode (codebook='bank'): quantize -> histogram -> select
# -> pack on the device, no host step between
# ---------------------------------------------------------------------------

# The provisioned pack grain: the single pass cannot size its output
# from the data without the host sync it exists to delete, so it packs
# into BANK_PROVISION_BITS bits/value and the host re-packs (pack only:
# the codes stay on the device) in the rare case a chunk's exact payload
# (hist . lengths, known from the one transfer) exceeds it.
BANK_PROVISION_BITS = 8


def _bank_w32(bits_per_value: int, chunk_values: int) -> int:
    """u32 provisioning for bits_per_value, trimmed like words_capacity
    so the valid prefix cuts to whole u64 words."""
    need = 2 * ((chunk_values * int(bits_per_value) + 63) // 64 + 1)
    return min(need, words_capacity(chunk_values))


def _bank_fits(totals: np.ndarray, w32: int) -> bool:
    """Whether every chunk's exact payload fits the provisioned pack."""
    return 2 * ((int(totals.max()) + 63) // 64 + 1) <= w32


@dataclasses.dataclass
class _RowsPass:
    """What one device pass over chunk rows leaves: device tensors
    throughout. q is flat for a whole array, (rows, cv) for a
    fixed-ratio window; the pack fields (sel .. block_nbits) are None
    when the pass did not pack."""
    hists: torch.Tensor
    sel: Optional[torch.Tensor]
    totals: Optional[torch.Tensor]
    words: Optional[torch.Tensor]
    block_nbits: Optional[torch.Tensor]
    codes2: torch.Tensor
    outl2: torch.Tensor
    delta2: torch.Tensor
    valid2: torch.Tensor
    q: torch.Tensor
    centers: Optional[torch.Tensor]


def _mega_pass(work, eb: float, predictor: str, n_chunks: int,
               chunk_values: int, block_size: int, w32: int, bank_lengths,
               bank_cwords, kernel_impl: str) -> _RowsPass:
    """The `ceaz_chunk` op over the chunk rows: 1-D Lorenzo and
    value-direct, the shapes whose Lorenzo halo is one raw value (the
    reference's ``_mega_pass_fn``)."""
    dev = work.device
    flat = work.reshape(-1)
    n = flat.numel()
    work2, valid2 = _chunk_rows(flat, n_chunks, chunk_values)
    prev2 = torch.zeros((n_chunks, 1), dtype=torch.float32, device=dev)
    if predictor == "lorenzo" and n_chunks > 1:
        # row i's halo: the RAW predecessor of its first value (row 0
        # gets the stream head's zero-pad)
        heads = torch.arange(1, n_chunks, device=dev) * chunk_values - 1
        prev2[1:, 0] = flat[heads]
    op = dispatch.resolve("ceaz_chunk", kernel_impl, dev)
    with dispatch.measure("ceaz_chunk", kernel_impl, dev):
        (q2, codes2, outl2, delta2, centers, hists, sel, totals, words,
         block_nbits) = op(work2, prev2, valid2,
                           _row_ebs([eb] * n_chunks, dev),
                           bank_lengths, bank_cwords, block_size, w32,
                           "value" if predictor == "none" else "lorenzo")
    return _RowsPass(hists, sel, totals, words, block_nbits, codes2, outl2,
                     delta2, valid2, q2.reshape(-1)[:n],
                     centers if predictor == "none" else None)


def _bank_pass(work, eb: float, ndim: int, n_chunks: int, chunk_values: int,
               block_size: int, w32: int, bank_lengths, bank_cwords,
               kernel_impl: str) -> _RowsPass:
    """Higher-rank Lorenzo (the reference's ``_bank_pass_fn``): the
    native-rank `dualquant` pass, per-chunk histograms by bincount, then
    the `bank_select` and `hufenc` ops."""
    dev = work.device
    codes2, outl2, delta2, valid2, q = _quantize_pass(
        work, eb, ndim, n_chunks, chunk_values, kernel_impl)
    hists = _chunk_hists(codes2, valid2, kernel_impl)
    select = dispatch.resolve("bank_select", kernel_impl, dev)
    with dispatch.measure("bank_select", kernel_impl, dev):
        sel, totals, ln_sel, cw_sel = select(hists, bank_lengths,
                                             bank_cwords)
    pack = dispatch.resolve("hufenc", kernel_impl, dev)
    with dispatch.measure("hufenc", kernel_impl, dev):
        words, block_nbits = pack(codes2, valid2, ln_sel, cw_sel,
                                  block_size, w32)
    return _RowsPass(hists, sel, totals, words, block_nbits, codes2, outl2,
                     delta2, valid2, q, None)


def compress_error_bounded_bank(x: np.ndarray, eb: float, mode: str,
                                coder: BankCoder, chunk_values: int,
                                block_size: int, device="cuda",
                                stats_on_device: Optional[bool] = None,
                                kernel_impl: str = "auto",
                                predictor: str = "lorenzo"):
    """Single-pass fused compression against an offline codebook bank.

    Each chunk's book comes from the coder's CodebookBank, selected on
    the device by the exact integer argmin of hist . lengths_k, so the
    whole encode — quantize, histogram, select, pack — runs before the
    one transfer. The host then replays the selection (``coder.step``)
    for the per-chunk decisions and the drift statistic the facade's
    fallback reads; the replay must land on the device's book
    (asserted). When a chunk's exact payload exceeds the
    BANK_PROVISION_BITS provisioning, only the pack re-runs at full
    capacity.
    """
    from ..core.ceaz import CEAZCompressed
    dev = target_device(device)
    bank = coder.bank
    if stats_on_device is None:
        stats_on_device = dev.type != "cpu"
    n = int(x.size)
    chunk_values = max(1, min(chunk_values, n))
    n_chunks, _ = chunk_layout(n, chunk_values)
    work, ndim = _work(x, predictor, dev)
    w32 = _bank_w32(min(int(bank.lengths.max()), BANK_PROVISION_BITS),
                    chunk_values)
    w32_full = _bank_w32(int(bank.lengths.max()), chunk_values)
    bank_lengths = torch.from_numpy(bank.lengths.astype(np.int32)).to(dev)
    bank_cwords = torch.from_numpy(
        bank.code_table().astype(np.uint32).view(np.int32)).to(dev)
    # the `ceaz_chunk` op covers the shapes whose Lorenzo halo is one
    # raw value — 1-D streams and value-direct; higher-rank Lorenzo
    # composes the stage ops (same outputs either way)
    if predictor == "none" or ndim == 1:
        bp = _mega_pass(work, eb, predictor, n_chunks, chunk_values,
                        block_size, w32, bank_lengths, bank_cwords,
                        kernel_impl)
    else:
        bp = _bank_pass(work, eb, ndim, n_chunks, chunk_values, block_size,
                        w32, bank_lengths, bank_cwords, kernel_impl)
    # --- host assembly from the one transfer ---
    hists_np = bp.hists.cpu().numpy().astype(np.int64)
    sel_np = bp.sel.cpu().numpy()
    totals_np = bp.totals.cpu().numpy().astype(np.int64)
    decisions = [coder.step(h) for h in hists_np]
    for i, d in enumerate(decisions):
        # the host replay of the selection statistic must land on the
        # same bank row the device argmin picked (integer-exact)
        assert d.bank_index == int(sel_np[i])
    words, block_nbits = bp.words, bp.block_nbits
    if w32 < w32_full and not _bank_fits(totals_np, w32):
        om.add(om.BANK_REPACKS)
        lengths_np, cwords_np = _codebook_tables(decisions)
        pack = dispatch.resolve("hufenc", kernel_impl, dev)
        with ot.span("fused.bank_overflow_repack"), \
                dispatch.measure("hufenc", kernel_impl, dev):
            words, block_nbits = pack(
                bp.codes2, bp.valid2, torch.from_numpy(lengths_np).to(dev),
                torch.from_numpy(cwords_np).to(dev), block_size, w32_full)
    p1 = _finish_pass1(bp.codes2, bp.outl2, bp.delta2, bp.valid2, bp.q,
                       work.reshape(-1), eb, chunk_values, stats_on_device,
                       hists=bp.hists, predictor=predictor,
                       centers=bp.centers)
    chunks = _assemble_chunks(
        p1, words.cpu().numpy().view(np.uint32), block_nbits.cpu().numpy(),
        totals_np, _outliers(p1), eb, decisions, block_size)
    lit_idx, lit_val = _literals(p1, x.reshape(-1), eb)
    return CEAZCompressed(shape=x.shape, dtype=str(x.dtype), ndim=ndim,
                          mode=mode, chunks=chunks,
                          word_bits=x.dtype.itemsize * 8,
                          predictor=predictor,
                          literal_idx=lit_idx, literal_val=lit_val)


# ---------------------------------------------------------------------------
# Fixed-ratio mode: the eb feedback loop, speculated in windows
# ---------------------------------------------------------------------------

def _spec_window(speculation) -> int:
    """Resolve the speculation knob: 'off' -> 1 (the sequential loop),
    'auto' -> 8 (then adapted per window, see `_next_window`), an int
    >= 1 -> that fixed window size."""
    if speculation == "off":
        return 1
    if speculation == "auto":
        return 8
    if isinstance(speculation, int) and not isinstance(speculation, bool) \
            and speculation >= 1:
        return int(speculation)
    raise ValueError(
        f"speculation must be 'off', 'auto' or an int >= 1, "
        f"got {speculation!r}")


# adaptive depth bounds ('auto' only): the floor keeps speculation from
# degrading into the sequential loop, the cap bounds how much
# speculative quantization one eb shift can discard
_SPEC_WINDOW_MIN = 2
_SPEC_WINDOW_MAX = 64


def _next_window(window: int, misses: int) -> int:
    """Adaptive speculation depth: a fully-hit window doubles the next
    one, any miss halves it. The depth never changes the emitted bytes,
    only how much speculative work a miss throws away (the
    ceaz_speculation_window gauge)."""
    if misses == 0:
        return min(window * 2, _SPEC_WINDOW_MAX)
    return max(window // 2, _SPEC_WINDOW_MIN)


def _chunk_total_bits(hist: np.ndarray, decision, n_outliers: int,
                      nblocks: int) -> int:
    """CompressedChunk.total_bits() from pass-1 summaries alone: the
    payload is exactly hist . lengths, so the eb feedback chain replays
    before any chunk is encoded."""
    from ..core.ceaz import BLOCK_COUNT_BITS, CHUNK_HEADER_BITS, OUTLIER_BITS
    bits = int(np.dot(hist.astype(np.int64),
                      decision.codebook.lengths.astype(np.int64)))
    bits += CHUNK_HEADER_BITS + BLOCK_COUNT_BITS * nblocks
    bits += OUTLIER_BITS * n_outliers
    if decision.stored_codebook:
        bits += 5 * NUM_SYMBOLS
    return bits


def _zero_halo_rows(seg2: torch.Tensor):
    """(valid2, prev2) of full chunk rows that are independent 1-D
    streams: every value valid, and a zero raw halo — exactly the
    per-chunk zero pad of the sequential loop."""
    w, cv = seg2.shape
    return (torch.ones((w, cv), dtype=torch.bool, device=seg2.device),
            torch.zeros((w, 1), dtype=torch.float32, device=seg2.device))


def _window_pass1(seg2: torch.Tensor, ebs, kernel_impl: str) -> _RowsPass:
    """Pass 1 of the exact coder over a window of full chunks: ONE
    `lorenzo_quant` launch quantizes every row at its own f32 bound and
    histograms it. A row's escape count is its histogram's code-0 bin
    (code 0 is the escape symbol), so the feedback replay needs no
    other summary."""
    dev = seg2.device
    valid2, prev2 = _zero_halo_rows(seg2)
    op = dispatch.resolve("lorenzo_quant", kernel_impl, dev)
    with dispatch.measure("lorenzo_quant", kernel_impl, dev):
        q2, codes2, outl2, delta2, hists = op(seg2, prev2, valid2,
                                              _row_ebs(ebs, dev))
    return _RowsPass(hists, None, None, None, None, codes2, outl2, delta2,
                     valid2, q2, None)


def _mega_window(seg2: torch.Tensor, ebs, bank_tables, block_size: int,
                 w32: int, kernel_impl: str) -> _RowsPass:
    """The bank coder's window: ONE `ceaz_chunk` op call over the rows
    at their own bounds. The packed words come back with the histograms,
    so a window that hits every forecast needs no second pass; `w32`
    provisions the bank's full bit-rate (no repack path)."""
    dev = seg2.device
    valid2, prev2 = _zero_halo_rows(seg2)
    op = dispatch.resolve("ceaz_chunk", kernel_impl, dev)
    with dispatch.measure("ceaz_chunk", kernel_impl, dev):
        (q2, codes2, outl2, delta2, _, hists, sel, totals, words,
         block_nbits) = op(seg2, prev2, valid2, _row_ebs(ebs, dev),
                           *bank_tables, block_size, w32, "lorenzo")
    return _RowsPass(hists, sel, totals, words, block_nbits, codes2, outl2,
                     delta2, valid2, q2, None)


def _replace_row(wp: _RowsPass, j: int, row: _RowsPass) -> None:
    """Overwrite row j of a window's device state with a one-row rerun."""
    for f in ("hists", "sel", "totals", "words", "block_nbits", "codes2",
              "outl2", "delta2", "q"):
        t = getattr(wp, f)
        if t is not None:
            t[j] = getattr(row, f)[0]


def compress_fixed_ratio(x: np.ndarray, ctrl, coder: AdaptiveCoder,
                         chunk_values: int, block_size: int, device="cuda",
                         adaptive: bool = True, exact_build: bool = False,
                         stats_on_device: Optional[bool] = None,
                         kernel_impl: str = "auto", speculation="auto"):
    """Fused fixed-ratio compression of the array as a 1-D stream of
    chunks on `device` (the card unless the caller asks for the CPU).

    Chunk i's bound depends on chunk i-1's achieved bit-rate, but a
    chunk's total bits are exactly ``hist . lengths`` plus per-chunk
    overheads, known before pass 2. So the loop SPECULATES: it forecasts
    the next w-1 bounds with the controller's rate law, quantizes the
    whole window in one launch, then replays the exact feedback chain on
    the host; a chunk whose forecast missed the exact bound is
    requantized alone at it. The stream is byte-identical to the
    sequential loop (``speculation='off'``) on every input.

    `ctrl` is a FixedRatioController (stepped in place); `coder` an
    AdaptiveCoder (window pass 2 is the `hufenc` pack) or a BankCoder
    (windows run the `ceaz_chunk` op, payload included). Windows cover
    full chunks only; the remaining full chunk and the partial one take
    the sequential tail (`dualquant`, then `hufenc`).
    """
    from ..core.ceaz import CEAZCompressed
    dev = target_device(device)
    window = _spec_window(speculation)
    adaptive_window = speculation == "auto"
    if stats_on_device is None:
        stats_on_device = dev.type != "cpu"
    flat = x.reshape(-1)
    n = len(flat)
    cv = chunk_values
    flat_t = torch.from_numpy(np.ascontiguousarray(
        flat, dtype=np.float32)).to(dev)
    use_bank = isinstance(coder, BankCoder)
    if use_bank:
        bank = coder.bank
        tables = (torch.from_numpy(bank.lengths.astype(np.int32)).to(dev),
                  torch.from_numpy(bank.code_table().astype(np.uint32)
                                   .view(np.int32)).to(dev))
        w32 = _bank_w32(int(bank.lengths.max()), cv)
        quantize = lambda rows, ebs: _mega_window(rows, ebs, tables,
                                                  block_size, w32,
                                                  kernel_impl)
    else:
        quantize = lambda rows, ebs: _window_pass1(rows, ebs, kernel_impl)
    nblocks = max(1, -(-cv // block_size))
    chunks, lit_idx_parts, lit_val_parts = [], [], []
    pos = 0                              # position in full-size chunks
    n_full = n // cv
    while window > 1 and n_full - pos >= 2:
        w = min(window, n_full - pos)
        ebs = [float(ctrl.eb)]           # the window head is always exact
        for _ in range(w - 1):
            ebs.append(ctrl.predict_next(ebs[-1]))
        s0 = pos * cv
        seg2 = flat_t[s0:s0 + w * cv].reshape(w, cv)
        with ot.span("fused.spec_window_pass1", window=w):
            wp = quantize(seg2, ebs)
            hists = wp.hists.cpu().numpy().astype(np.int64)
            sel = wp.sel.cpu().numpy() if use_bank else None
        # replay the exact sequential feedback chain from the summaries;
        # a mispredicted chunk requantizes alone at its exact bound
        decisions, fed_bits, misses = [], [], 0
        for j in range(w):
            if j > 0 and ebs[j] != float(ctrl.eb):
                ebs[j] = float(ctrl.eb)
                misses += 1
                with ot.span("fused.spec_repair", chunk=pos + j):
                    row = quantize(seg2[j:j + 1], ebs[j:j + 1])
                    _replace_row(wp, j, row)
                    hists[j] = row.hists[0].cpu().numpy()
                    if use_bank:
                        sel[j] = int(row.sel[0])
            d = _policy(hists[j:j + 1], coder, adaptive, exact_build)[0]
            if use_bank and d.bank_index != int(sel[j]):
                raise RuntimeError(
                    f"chunk {pos + j}: the host bank replay picked book "
                    f"{d.bank_index}, the device {int(sel[j])}")
            bits = _chunk_total_bits(hists[j], d, int(hists[j, 0]), nblocks)
            ctrl.feedback(bits / cv)
            decisions.append(d)
            fed_bits.append(bits)
        # the window head is exact by construction: w-1 chunks were
        # speculated, the repaired ones mispredicted
        om.add(om.SPEC_MISSES, misses)
        om.add(om.SPEC_HITS, (w - 1) - misses)
        if use_bank:
            words_np = wp.words.cpu().numpy().view(np.uint32)
            nbits_np = wp.block_nbits.cpu().numpy()
            totals = wp.totals.cpu().numpy().astype(np.int64)
        else:                            # one pass 2 over the window
            words_np, nbits_np, totals = _encode_rows(
                hists, wp.codes2, wp.valid2, cv, decisions, block_size,
                kernel_impl)
        p1 = _finish_pass1(wp.codes2, wp.outl2, wp.delta2, wp.valid2, wp.q,
                           seg2, _row_ebs(ebs, dev)[:, None], cv,
                           stats_on_device, hists=hists)
        new = _assemble_chunks(p1, words_np, nbits_np, totals, _outliers(p1),
                               ebs, decisions, block_size)
        for j, ch in enumerate(new):
            if ch.total_bits() != fed_bits[j]:
                raise RuntimeError(
                    f"chunk {pos + j}: {ch.total_bits()} bits emitted, "
                    f"{fed_bits[j]} fed back to the rate controller")
        li, lv = _literals(p1, flat[s0:s0 + w * cv], ebs)
        lit_idx_parts.append(li + s0)
        lit_val_parts.append(lv)
        chunks.extend(new)
        pos += w
        if adaptive_window:
            window = _next_window(window, misses)
            om.set_gauge(om.SPEC_WINDOW, window)
    # sequential tail: the remaining full chunks (speculation off, or one
    # full chunk left) and the final partial chunk
    for s in range(pos * cv, n, cv):
        e = min(s + cv, n)
        eb = float(ctrl.eb)
        p1 = _run_pass1(flat_t[s:e], eb, 1, e - s, stats_on_device,
                        kernel_impl)
        decisions = _policy(p1.hists, coder, adaptive, exact_build)
        words_np, nbits_np, totals = _encode_rows(
            p1.hists, p1.codes2, p1.valid2, e - s, decisions, block_size,
            kernel_impl)
        ch = _assemble_chunks(p1, words_np, nbits_np, totals, _outliers(p1),
                              eb, decisions, block_size)[0]
        li, lv = _literals(p1, flat[s:e], eb)
        lit_idx_parts.append(li + s)
        lit_val_parts.append(lv)
        chunks.append(ch)
        ctrl.feedback(ch.total_bits() / ch.n_values)
    return CEAZCompressed(shape=x.shape, dtype=str(x.dtype), ndim=1,
                          mode="fixed_ratio", chunks=chunks,
                          word_bits=x.dtype.itemsize * 8,
                          literal_idx=np.concatenate(lit_idx_parts)
                          .astype(np.int64),
                          literal_val=np.concatenate(lit_val_parts))


# ---------------------------------------------------------------------------
# Batched compression of same-shape shards: one pass pair for a group
# ---------------------------------------------------------------------------

def batch_compress(shards, eb_rel: float, chunk_values: int, block_size: int,
                   offline: Codebook, mode: str = "rel", device="cuda",
                   plan=None, stats_on_device: Optional[bool] = None,
                   tau0: float = DEFAULT_TAU0, tau1: float = DEFAULT_TAU1,
                   adaptive: bool = True, exact_build: bool = False,
                   kernel_impl: str = "auto", predictor: str = "lorenzo"):
    """Compress same-shape, same-dtype shards through one pass pair on
    `device` (the card unless the caller asks for the CPU).

    Pass 1 quantizes every shard at its own bound (rel: `eb_rel` times
    the shard's value range): the `dualquant` op once a shard for
    Lorenzo (each shard its own Lorenzo field), or ONE value-direct pass
    over all shards' chunk rows. The histograms of all chunk rows come
    from one `histogram` launch (value-direct: from the finalize), each
    shard keeps its own AdaptiveCoder stream, and ONE `hufenc` pack
    covers every shard's chunks. Each result equals the shard's own
    ``compress_error_bounded`` bit for bit (the reference's
    ``runtime/fused.py::batch_compress``). With a rank plan (a mesh of
    several processes) each batch position's rank runs the passes for
    its contiguous block of shards on its device and every rank returns
    the whole list, ``plan=None``'s bit for bit
    (``runtime/sharding.py::distribute``); a logical mesh runs them on
    the device it names.
    """
    from ..core.ceaz import CEAZCompressed
    from .sharding import distribute, is_rank_plan, plan_device
    if len({s.shape for s in shards}) != 1:
        raise ValueError("batch_compress requires same-shape shards")
    if len({s.dtype for s in shards}) != 1:
        raise ValueError("batch_compress requires same-dtype shards")
    dev = target_device(plan_device(plan, "batch_compress") or device)
    if is_rank_plan(plan):
        return distribute(list(shards), plan, lambda blk: batch_compress(
            blk, eb_rel, chunk_values, block_size, offline, mode=mode,
            device=dev, stats_on_device=stats_on_device, tau0=tau0,
            tau1=tau1, adaptive=adaptive, exact_build=exact_build,
            kernel_impl=kernel_impl, predictor=predictor))
    if stats_on_device is None:
        stats_on_device = dev.type != "cpu"
    ebs = [eb_rel * core_dq.value_range(s) if mode == "rel" else eb_rel
           for s in shards]
    n = int(shards[0].size)
    chunk_values = max(1, min(chunk_values, n))
    n_chunks, _ = chunk_layout(n, chunk_values)
    works = [_work(s, predictor, dev) for s in shards]
    ndim = works[0][1]
    works = [w for w, _ in works]
    rows = lambda si: slice(si * n_chunks, (si + 1) * n_chunks)
    p1s: List[_Pass1] = []
    if predictor == "none":
        parts = [_chunk_rows(w.reshape(-1), n_chunks, chunk_values)
                 for w in works]
        valid2 = torch.cat([v for _, v in parts])
        q2, codes2, outl2, delta2, centers, hists = _value_rows(
            torch.cat([w for w, _ in parts]), valid2,
            _row_ebs([e for e in ebs for _ in range(n_chunks)], dev),
            kernel_impl)
        for si, w in enumerate(works):
            sl = rows(si)
            p1s.append(_finish_pass1(
                codes2[sl], outl2[sl], delta2[sl], valid2[sl],
                q2[sl].reshape(-1)[:n], w.reshape(-1), ebs[si],
                chunk_values, stats_on_device, hists=hists[sl],
                predictor="none", centers=centers[sl]))
    else:
        passes = [_quantize_pass(w, ebs[si], ndim, n_chunks, chunk_values,
                                 kernel_impl) for si, w in enumerate(works)]
        codes2 = torch.cat([p[0] for p in passes])
        valid2 = torch.cat([p[3] for p in passes])
        hists = (_chunk_hists(codes2, valid2, kernel_impl)
                 if stats_on_device else None)
        for si, (c2, o2, d2, v2, q) in enumerate(passes):
            p1s.append(_finish_pass1(
                c2, o2, d2, v2, q, works[si].reshape(-1), ebs[si],
                chunk_values, stats_on_device,
                hists=None if hists is None else hists[rows(si)]))
    decisions = [_policy(p.hists, AdaptiveCoder(offline, tau0, tau1,
                                                exact_build),
                         adaptive, exact_build) for p in p1s]
    words_np, nbits_np, totals = _encode_rows(
        np.concatenate([p.hists for p in p1s]), codes2, valid2,
        chunk_values, [d for ds in decisions for d in ds], block_size,
        kernel_impl)
    outs = []
    for si, s in enumerate(shards):
        sl = rows(si)
        chunks = _assemble_chunks(p1s[si], words_np[sl], nbits_np[sl],
                                  totals[sl], _outliers(p1s[si]), ebs[si],
                                  decisions[si], block_size)
        lit_idx, lit_val = _literals(p1s[si], s.reshape(-1), ebs[si])
        outs.append(CEAZCompressed(
            shape=s.shape, dtype=str(s.dtype), ndim=ndim, mode=mode,
            chunks=chunks, word_bits=s.dtype.itemsize * 8,
            predictor=predictor, literal_idx=lit_idx, literal_val=lit_val))
    return outs
