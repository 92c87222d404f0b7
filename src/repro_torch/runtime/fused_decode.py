"""Fused CEAZ decode: the decode-megakernel route and the split route.

Port of the reference's ``runtime/fused_decode.py``. All chunks of all
streams in a group are staged on the host into padded rows and decoded
by ONE device pass, one of two:

  * the megakernel route (``decompress_batch(megakernel=True)``, the
    default) — ONE call of the `ceaz_chunk_dec` op: table walk, outlier
    patch and inverse dual-quant. 1-D abs/rel streams carry their
    Lorenzo chain across chunk rows in the op, fixed-ratio rows are each
    a chain of their own, higher-rank fields take the multi-axis cumsum
    afterwards (:func:`_nd_cumsum`), and value-direct rows add their
    chunk's centre (``base``) with no prefix sum;
  * the split route (``megakernel=False``) — the `hufdec` walk alone,
    then per stream the outlier scatter and the inverse (cumsums, or the
    centre add) as plain torch ops on the device
    (:func:`decompress_one`).

Bank chunks resolve their book from the CodebookBank they name. The host
then replays the staged float64 scale multiply (per chunk for
fixed-ratio and value-direct streams) and patches the literals.

Bit-exactness contract: the decoded bytes equal the reference's for
every stream the encoder produces (float32/float64, Lorenzo or
value-direct, abs/rel/fixed_ratio, exact or bank codebooks), on both
routes.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core import dualquant as core_dq
from ..core.huffman import DEFAULT_MAX_LEN, Codebook, replay_codebooks
from ..kernels import dispatch
from ..kernels.hufdec import ops as hufdec
from .fused import target_device

MAX_CODE_BITS = DEFAULT_MAX_LEN
_TBL = 1 << MAX_CODE_BITS


def _u64_to_u32(w64: np.ndarray) -> np.ndarray:
    """Split the u64 wire words into the device's MSB-first u32 pairs."""
    out = np.empty(2 * len(w64), np.uint32)
    out[0::2] = (w64 >> np.uint64(32)).astype(np.uint32)
    out[1::2] = (w64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def _bucket_pow2(n: int, floor: int = 1) -> int:
    b = max(floor, 1)
    while b < n:
        b *= 2
    return b


def _bucket_words(n: int) -> int:
    """u32 capacity buckets: powers of two up to a page, then pages."""
    if n <= 4096:
        return _bucket_pow2(n, 4)
    return -(-n // 4096) * 4096


def fused_decode_ok(c, offline: Codebook) -> bool:
    """Streams these routes decode: float32/float64 Lorenzo or
    value-direct abs/rel/fixed_ratio streams with chunks, codebooks at
    the standard length limit."""
    return (getattr(c, "predictor", "lorenzo") in ("lorenzo", "none")
            and np.dtype(c.dtype) in (np.float32, np.float64)
            and c.mode in ("abs", "rel", "fixed_ratio")
            and len(c.chunks) > 0
            and offline.max_len == MAX_CODE_BITS)


class _ChunkBatch:
    """Host staging of one group's chunks for the batched decode pass."""

    def __init__(self, block_size: int, device, kernel_impl: str = "auto"):
        self.block_size = block_size
        self.device = torch.device(device)
        self.kernel_impl = kernel_impl
        self.words: List[np.ndarray] = []          # u32 per chunk
        self.nbits: List[np.ndarray] = []
        self.counts: List[int] = []
        self.books: List[Codebook] = []
        self.spans: List[Tuple[int, int]] = []     # comp -> row range
        # per-row megakernel metadata: outlier deltas (ascending position
        # order), value-direct centre base, Lorenzo-row flag,
        # carry-segment head row
        self.odelta: List[np.ndarray] = []
        self.base: List[int] = []
        self.islor: List[int] = []
        self.seg0: List[int] = []

    def add_comp(self, c, offline: Codebook, bank=None):
        row0 = len(self.counts)
        value = getattr(c, "predictor", "lorenzo") == "none"
        # one flat Lorenzo chain across the comp's rows only when the
        # work shape IS flat (abs/rel); fixed-ratio rows are each a chain
        # of their own; higher-rank fields decode per-row deltas and run
        # the multi-axis cumsum in decompress_one_mega
        chained = (not value and c.mode in ("abs", "rel")
                   and len(c.shape) == 1)
        lor1d = not value and (c.mode == "fixed_ratio" or chained)
        for j, (ch, book) in enumerate(
                zip(c.chunks, replay_codebooks(c.chunks, offline,
                                               bank=bank))):
            self.words.append(_u64_to_u32(ch.words))
            self.nbits.append(np.asarray(ch.block_nbits, np.int64))
            self.counts.append(int(ch.n_values))
            self.books.append(book)
            self.odelta.append(ch.outlier_delta)
            self.base.append(int(ch.center) if value else 0)
            self.islor.append(1 if lor1d else 0)
            self.seg0.append(row0 if chained else row0 + j)
        self.spans.append((row0, len(self.counts)))

    def _stage(self):
        """Pad the staged chunks to capacity buckets and stack the unique
        decode tables."""
        C = len(self.counts)
        c_cap = _bucket_pow2(C)
        nb_cap = _bucket_pow2(max(len(b) for b in self.nbits))
        w_need = max(len(w) for w in self.words) + 2
        w_cap = _bucket_words(w_need)
        words2 = np.zeros((c_cap, w_cap), np.uint32)
        nbits2 = np.zeros((c_cap, nb_cap), np.int32)
        counts = np.zeros(c_cap, np.int32)
        for i, (w, nb) in enumerate(zip(self.words, self.nbits)):
            words2[i, :len(w)] = w
            nbits2[i, :len(nb)] = nb
            counts[i] = self.counts[i]
        uniq: Dict[str, int] = {}
        tables_sym, tables_len = [], []
        cb_idx = np.zeros(c_cap, np.int32)
        for i, book in enumerate(self.books):
            k = uniq.get(book.id)
            if k is None:
                k = uniq[book.id] = len(tables_sym)
                sym, ln = book.tables()
                tables_sym.append(sym)
                tables_len.append(ln)
            cb_idx[i] = k
        k_cap = _bucket_pow2(len(tables_sym))
        while len(tables_sym) < k_cap:
            tables_sym.append(np.zeros(_TBL, np.uint16))
            tables_len.append(np.zeros(_TBL, np.uint8))
        return (words2, nbits2, counts,
                np.concatenate(tables_sym).astype(np.int32),
                np.concatenate(tables_len).astype(np.int32), cb_idx)

    def _tables(self, sym_flat: np.ndarray, len_flat: np.ndarray):
        """The stacked decode tables on the device, marked as checked: a
        book's table holds its used symbols and their lengths
        (Codebook.tables), checked here on the host, so the walks'
        wrappers need not wait on the card for their own check."""
        for book in {b.id: b for b in self.books}.values():
            hufdec.check_table_ranges(np.flatnonzero(book.lengths),
                                      book.lengths)
        tables = (torch.from_numpy(sym_flat).to(self.device),
                  torch.from_numpy(len_flat).to(self.device))
        hufdec.mark_ranges_checked(*tables)
        return tables

    def run(self) -> torch.Tensor:
        """-> codes (C_cap, NB_cap*block_size) int32 on the device: the
        `hufdec` walk over the whole group (the split route)."""
        words2, nbits2, counts, sym_flat, len_flat, cb_idx = self._stage()
        dev = self.device
        t = lambda a: torch.from_numpy(a).to(dev)
        tables = self._tables(sym_flat, len_flat)
        fn = dispatch.resolve("hufdec", self.kernel_impl, dev)
        with dispatch.measure("hufdec", self.kernel_impl, dev):
            return fn(t(words2.view(np.int32)), t(nbits2), t(counts),
                      *tables, t(cb_idx), self.block_size)

    def run_mega(self) -> torch.Tensor:
        """-> q (C_cap, NB_cap*block_size) int32 on the device: the
        `ceaz_chunk_dec` op over the whole group."""
        words2, nbits2, counts, sym_flat, len_flat, cb_idx = self._stage()
        c_cap = len(counts)
        C = len(self.counts)
        k = _bucket_pow2(max(1, max(len(d) for d in self.odelta)))
        odelta2 = np.zeros((c_cap, k), np.int32)
        for i, d in enumerate(self.odelta):
            odelta2[i, :len(d)] = d.astype(np.int32)
        islor = np.zeros(c_cap, np.int32)
        islor[:C] = self.islor
        seg0 = np.arange(c_cap, dtype=np.int32)    # padding: own segment
        seg0[:C] = self.seg0
        if (seg0 < 0).any() or (seg0 > np.arange(c_cap)).any():
            raise ValueError("ceaz_chunk_dec: a row's segment head seg0[c] "
                             "must lie in [0, c]")
        tables = self._tables(sym_flat, len_flat)
        base = np.zeros(c_cap, np.int32)           # value-direct centres
        base[:C] = np.asarray(self.base, np.int64).astype(np.int32)
        dev = self.device
        t = lambda a: torch.from_numpy(a).to(dev)
        fn = dispatch.resolve("ceaz_chunk_dec", self.kernel_impl, dev)
        with dispatch.measure("ceaz_chunk_dec", self.kernel_impl, dev):
            return fn(t(words2.view(np.int32)), t(nbits2), t(counts),
                      *tables, t(cb_idx), t(odelta2), t(base), t(seg0),
                      t(islor), self.block_size)


# ---------------------------------------------------------------------------
# The split route's tail: outlier scatter + inverse dual-quant, plain torch
# ops on the device
# ---------------------------------------------------------------------------

def _padded_outliers(chunks, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, K) outlier index/delta tensors; padding indices point far past
    the chunk so the scatter drops them."""
    k = max(1, max(len(ch.outlier_idx) for ch in chunks))
    oidx = np.full((len(chunks), k), 1 << 30, np.int32)
    odelta = np.zeros((len(chunks), k), np.int32)
    for i, ch in enumerate(chunks):
        m = len(ch.outlier_idx)
        oidx[i, :m] = ch.outlier_idx.astype(np.int32)
        odelta[i, :m] = ch.outlier_delta.astype(np.int32)
    return (torch.from_numpy(oidx).to(device),
            torch.from_numpy(odelta).to(device))


def _scatter_outliers(codes2: torch.Tensor, oidx2: torch.Tensor,
                      odelta2: torch.Tensor) -> torch.Tensor:
    """codes -> int32 deltas with the escape symbols replaced by their
    stored values. As the reference's ``mode='drop'`` scatter: a negative
    index counts from the row's end once, and an index still outside the
    row (the padding) is dropped — masked out before the scatter, which
    torch would otherwise refuse (or, on the card, write out of range)."""
    delta2 = codes2.to(torch.int32) - core_dq.RADIUS
    cv = delta2.shape[1]
    idx = torch.where(oidx2 < 0, oidx2 + cv, oidx2).to(torch.int64)
    keep = (idx >= 0) & (idx < cv)
    rows = torch.arange(delta2.shape[0], device=delta2.device)[:, None] \
        .expand_as(idx)
    delta2[rows[keep], idx[keep]] = odelta2[keep]
    return delta2


def _inverse_nd(codes2, oidx2, odelta2, ndim: int, n: int, work_shape
                ) -> torch.Tensor:
    """abs/rel: one Lorenzo field cut into chunks -> flat integer q; the
    cumsums cross chunk boundaries as the encoder's whole-array pass
    did."""
    delta2 = _scatter_outliers(codes2, oidx2, odelta2)
    delta = delta2.reshape(-1)[:n].reshape(work_shape)
    return core_dq.inverse_lorenzo(delta, ndim).reshape(-1)


def _inverse_1d_chunks(codes2, oidx2, odelta2) -> torch.Tensor:
    """fixed_ratio: every chunk is an independent 1-D stream (the int64
    cumsum wrapped back to int32, the reference's int32 residues)."""
    delta2 = _scatter_outliers(codes2, oidx2, odelta2)
    return torch.cumsum(delta2, dim=1).to(torch.int32)


def _inverse_value_chunks(codes2, oidx2, odelta2, centers) -> torch.Tensor:
    """value-direct: per-chunk centre add, no prefix sum, wrapped to
    int32 as the encoder's wrapped deltas."""
    delta2 = _scatter_outliers(codes2, oidx2, odelta2)
    return (delta2.to(torch.int64) + centers[:, None]).to(torch.int32)


def _chunk_parts(c, q2: np.ndarray):
    """Per-chunk q rows cut to their lengths, and each value's 2*eb."""
    q = np.concatenate([q2[i, :ch.n_values]
                        for i, ch in enumerate(c.chunks)])
    ebs = np.repeat([2.0 * ch.eb for ch in c.chunks],
                    [ch.n_values for ch in c.chunks])
    return q, ebs


def decompress_one(codes_rows: torch.Tensor, c) -> np.ndarray:
    """The split route's tail for one stream, given its decoded chunk rows
    (on the device, possibly wider than the stream's chunk_values)."""
    cv = int(c.chunks[0].n_values)
    n = int(c.n_values)
    dev = codes_rows.device
    oidx, odelta = _padded_outliers(c.chunks, dev)
    rows = codes_rows[:, :cv]
    if getattr(c, "predictor", "lorenzo") == "none":
        centers = torch.tensor([int(ch.center) for ch in c.chunks],
                               dtype=torch.int64, device=dev)
        q2 = _inverse_value_chunks(rows, oidx, odelta, centers)
        return _finish_host(c, *_chunk_parts(c, q2.cpu().numpy()))
    if c.mode in ("abs", "rel"):
        q = _inverse_nd(rows, oidx, odelta, c.ndim, n, _work_shape(c))
        return _finish_host(c, q.cpu().numpy(),
                            np.float64(2.0 * c.chunks[0].eb))
    q2 = _inverse_1d_chunks(rows, oidx, odelta)
    return _finish_host(c, *_chunk_parts(c, q2.cpu().numpy()))


def _finish_host(c, q: np.ndarray, eb_per_value) -> np.ndarray:
    """The staged float64 formula + literal patch — the only host math."""
    out_dtype = np.dtype(c.dtype)
    rec = (q.astype(np.float64) * eb_per_value).astype(out_dtype)
    rec[c.literal_idx] = c.literal_val.astype(out_dtype)
    return rec.reshape(c.shape)


def _work_shape(c) -> tuple:
    if len(c.shape) <= 3:
        return tuple(int(s) for s in c.shape)
    tail = tuple(int(s) for s in c.shape[-2:])
    lead = int(np.prod(c.shape[:-2]))
    return (lead,) + tail


def _nd_cumsum(delta2: torch.Tensor, ndim: int, n: int, work_shape
               ) -> torch.Tensor:
    """Multi-axis inverse Lorenzo of delta rows (higher-rank fields)."""
    delta = delta2.reshape(-1)[:n].reshape(work_shape)
    return core_dq.inverse_lorenzo(delta, ndim).reshape(-1)


def decompress_one_mega(q_rows: torch.Tensor, c) -> np.ndarray:
    """Host finish for one array, given its reconstructed q rows (1-D
    chains already summed and value-direct centres added in the op;
    higher-rank rows arrive as deltas and take the multi-axis cumsum
    here)."""
    cv = int(c.chunks[0].n_values)
    n = int(c.n_values)
    rows = q_rows[:, :cv]
    if (getattr(c, "predictor", "lorenzo") == "none"
            or c.mode == "fixed_ratio"):
        # per-chunk rows are final q, each with its chunk's eb
        return _finish_host(c, *_chunk_parts(c, rows.cpu().numpy()))
    if len(c.shape) == 1:
        # the flat Lorenzo chain was carried across the chunk boundaries
        # in the op
        q = rows.reshape(-1)[:n]
    else:
        q = _nd_cumsum(rows, c.ndim, n, _work_shape(c))
    return _finish_host(c, q.cpu().numpy(), np.float64(2.0 * c.chunks[0].eb))


def decompress_batch(comps: Sequence, block_size: int, offline: Codebook,
                     device="cuda", kernel_impl: str = "auto", bank=None,
                     megakernel: bool = True) -> List[np.ndarray]:
    """Fused decode of a group of CEAZCompressed streams on `device`
    (the card unless the caller asks for the CPU): ONE pass over every
    chunk of the group — the `ceaz_chunk_dec` op with `megakernel`, else
    the `hufdec` walk followed by each stream's plain torch tail. Both
    routes give the same bytes. Bank chunks resolve their book from
    `bank` when its id matches, else from the bank registry. Callers
    filter with :func:`fused_decode_ok` first (the facade does)."""
    batch = _ChunkBatch(block_size, target_device(device), kernel_impl)
    for c in comps:
        batch.add_comp(c, offline, bank=bank)
    if not batch.counts:
        return []
    if megakernel:
        q_all = batch.run_mega()
        return [decompress_one_mega(q_all[r0:r1], c)
                for c, (r0, r1) in zip(comps, batch.spans)]
    codes_all = batch.run()
    return [decompress_one(codes_all[r0:r1], c)
            for c, (r0, r1) in zip(comps, batch.spans)]
