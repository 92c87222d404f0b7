"""Fused CEAZ encode: the exact two-pass abs/rel Lorenzo route.

Port of the reference's ``runtime/fused.py::compress_error_bounded``
(Lorenzo predictor) on torch tensors:

  pass 1  — the `dualquant` op quantizes the WHOLE array (native-rank
            global Lorenzo) into the chunked layout and yields the
            prequantized field q the literal check replays; per-chunk
            histograms (and, on the card, literal candidates) are the
            only summaries that reach the host.
  host    — the chi / codebook policy (AdaptiveCoder) on the histograms.
  pass 2  — the `hufenc` op gather-packs every chunk against its own
            codebook; payload words and block bit counts come back in one
            transfer each.

Bit-exactness contract: for the same input the result is bit-identical
to the reference's ``CEAZ(use_fused=True)`` in every CEAZCompressed
field (tests/test_torch_ceaz.py). The payload is packed in u32 words
(int32 storage) and folded into the u64 wire words on the host.

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
from ..core.codebook import AdaptiveCoder, AdaptiveDecision
from ..core.huffman import DEFAULT_MAX_LEN, NUM_SYMBOLS, Codebook
from ..kernels import dispatch
from ..obs import trace as ot

# The wire format assumes codes never exceed 16 bits.
MAX_CODE_BITS = DEFAULT_MAX_LEN
_EPS32 = float(np.finfo(np.float32).eps)


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


def _device_stats(codes2, valid2, q, work_flat, eb: float):
    """Card path: per-chunk histograms + literal candidates as device ops.

    The decompressor reconstructs through a float64 multiply; here only
    the float32 formula runs, so a conservative CANDIDATE set (few-ulp
    guard band) is collected with the exact integer q at each candidate
    — the host replays the float64 formula on just those.
    """
    n_chunks = codes2.shape[0]
    dev = codes2.device
    rows = torch.arange(n_chunks, device=dev)[:, None] * NUM_SYMBOLS
    # padding lands in one extra bin past the last chunk's
    keys = torch.where(valid2, rows + codes2.to(torch.int64),
                       n_chunks * NUM_SYMBOLS)
    hists = torch.bincount(keys.reshape(-1),
                           minlength=n_chunks * NUM_SYMBOLS + 1)
    hists = hists[:n_chunks * NUM_SYMBOLS].reshape(n_chunks, NUM_SYMBOLS)
    eb32 = core_dq.f32_scalar(eb, dev)
    rec = q.to(torch.float32) * (eb32 * 2.0)
    margin = (core_dq.f32_scalar(16.0 * _EPS32, dev)
              * (rec.abs() + work_flat.abs())
              + core_dq.f32_scalar(1e-38, dev))
    cand = (rec - work_flat).abs() > (eb32 - margin)
    lit_idx, lit_q = _extract_sparse(cand, q)
    return hists, lit_idx, lit_q


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
    # host-stats branch: snapshots
    codes_host: Optional[np.ndarray] = None
    q_host: Optional[np.ndarray] = None


def _host_hists(codes_host: np.ndarray, n: int) -> np.ndarray:
    """Per-chunk histograms in ONE bincount pass."""
    nc, cv = codes_host.shape
    flat = codes_host.reshape(-1)[:n].astype(np.int64)
    keys = flat + (np.arange(n, dtype=np.int64) // cv) * NUM_SYMBOLS
    return np.bincount(keys, minlength=nc * NUM_SYMBOLS) \
        .reshape(nc, NUM_SYMBOLS)


def _run_pass1(work: torch.Tensor, eb: float, ndim: int, chunk_values: int,
               stats_on_device: Optional[bool], kernel_impl: str) -> _Pass1:
    if stats_on_device is None:
        stats_on_device = work.device.type != "cpu"
    n = work.numel()
    n_chunks, _ = chunk_layout(n, chunk_values)
    codes2, outl2, delta2, valid2, q = _quantize_pass(
        work, eb, ndim, n_chunks, chunk_values, kernel_impl)
    if stats_on_device:
        hists, lit_idx, lit_q = _device_stats(codes2, valid2, q,
                                              work.reshape(-1), eb)
        return _Pass1(codes2, outl2, delta2, valid2, q,
                      hists.cpu().numpy(), n, n_chunks, chunk_values, True,
                      lit_idx=lit_idx, lit_q=lit_q)
    codes_host = codes2.cpu().numpy()
    return _Pass1(codes2, outl2, delta2, valid2, q,
                  _host_hists(codes_host, n), n, n_chunks, chunk_values,
                  False, codes_host=codes_host, q_host=q.cpu().numpy())


# ---------------------------------------------------------------------------
# Host side and pass 2
# ---------------------------------------------------------------------------

def _literals(p1: _Pass1, x_flat: np.ndarray, eb: float
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact literal set (identical to the staged float64 check): the
    reconstruction is rounded through the ORIGINAL dtype and compared
    with the caller's original values — densely on the host snapshot,
    or on the device's candidates only."""
    out_dtype = x_flat.dtype
    if p1.stats_on_device:
        idx = p1.lit_idx.cpu().numpy().astype(np.int64)
        q = p1.lit_q.cpu().numpy().astype(np.int64)
        x_c = x_flat[idx]
    else:
        idx = None
        q = p1.q_host.astype(np.int64)
        x_c = x_flat
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


def _u32_to_u64(u32: np.ndarray) -> np.ndarray:
    """Fold MSB-first u32 pairs into the u64 wire words."""
    return ((u32[0::2].astype(np.uint64) << np.uint64(32))
            | u32[1::2].astype(np.uint64))


def _assemble_chunks(p1: _Pass1, words_np, nbits_np, totals, outliers,
                     eb: float, decisions, block_size: int) -> List:
    """Host CompressedChunk records from the batched transfers."""
    from ..core.ceaz import CompressedChunk
    chunks = []
    for i, decision in enumerate(decisions):
        n_i = _chunk_len(p1, i)
        nw64 = (int(totals[i]) + 63) // 64
        words = _u32_to_u64(words_np[i, :2 * (nw64 + 1)])
        nblocks = max(1, -(-n_i // block_size))
        oi, od = outliers[i]
        chunks.append(CompressedChunk(
            words=words, block_nbits=nbits_np[i, :nblocks].astype(np.int64),
            n_values=n_i, eb=eb,
            action=decision.action, chi=decision.chi,
            codebook_lengths=(decision.codebook.lengths.copy()
                              if decision.stored_codebook else None),
            codebook_id=decision.codebook.id,
            outlier_idx=oi, outlier_delta=od))
    return chunks


def _policy(hists: np.ndarray, coder: AdaptiveCoder, adaptive: bool,
            exact_build: bool):
    """Host chi policy over the per-chunk histogram summaries."""
    decisions = []
    for freqs in hists.astype(np.int64):
        if adaptive:
            decisions.append(coder.step(freqs))
        else:
            cb = Codebook.from_freqs(freqs, exact=exact_build)
            decisions.append(AdaptiveDecision("rebuild", 0.0, cb, True))
    return decisions


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def compress_error_bounded(x: np.ndarray, eb: float, mode: str,
                           coder: AdaptiveCoder, chunk_values: int,
                           block_size: int, device="cpu",
                           adaptive: bool = True, exact_build: bool = False,
                           stats_on_device: Optional[bool] = None,
                           kernel_impl: str = "auto"):
    """Fused abs/rel Lorenzo compression of a float32/float64 array.

    The array is quantized ONCE on `device` (native-rank Lorenzo, the
    f32 pass for float64 input too — the float64 bound is restored by
    the literal channel) and the code stream is cut into chunks for the
    adaptive coder. Returns a CEAZCompressed.
    """
    from ..core.ceaz import CEAZCompressed
    # capping at the stream length keeps chunk boundaries identical and
    # avoids padding the pipeline up to a chunk nothing fills
    chunk_values = max(1, min(chunk_values, int(x.size)))
    ndim = min(x.ndim, 3)
    work_shape = x.shape if x.ndim <= 3 else (-1,) + x.shape[-2:]
    work = torch.from_numpy(np.ascontiguousarray(
        x.reshape(work_shape), dtype=np.float32)).to(device)
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
                          predictor="lorenzo",
                          literal_idx=lit_idx, literal_val=lit_val)
