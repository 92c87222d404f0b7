"""Fused CEAZ decode: the decode-megakernel route.

Port of the reference's ``runtime/fused_decode.py`` megakernel route
(``decompress_batch(megakernel=True)``): all chunks of all streams in a
group are staged on the host into padded rows and decoded by ONE call of
the `ceaz_chunk_dec` op — table walk, outlier patch and inverse
dual-quant; 1-D streams carry their Lorenzo chain across chunk rows in
the op, higher-rank fields take the multi-axis cumsum afterwards
(:func:`_nd_cumsum`), and value-direct rows add their chunk's centre
(``base``) with no prefix sum. Bank chunks resolve their book from the
CodebookBank they name. The host then replays the staged float64 scale
multiply and patches the literals.

Bit-exactness contract: the decoded bytes equal the reference's for
every stream the encoder produces (float32/float64, Lorenzo or
value-direct, abs/rel, exact or bank codebooks).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core import dualquant as core_dq
from ..core.huffman import DEFAULT_MAX_LEN, Codebook, replay_codebooks
from ..kernels import dispatch
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
    """Streams this route decodes: float32/float64 Lorenzo or
    value-direct abs/rel streams with chunks, codebooks at the standard
    length limit."""
    return (getattr(c, "predictor", "lorenzo") in ("lorenzo", "none")
            and np.dtype(c.dtype) in (np.float32, np.float64)
            and c.mode in ("abs", "rel")
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
        # work shape IS flat; higher-rank fields decode per-row deltas
        # and run the multi-axis cumsum in decompress_one_mega
        chained = not value and len(c.shape) == 1
        for j, (ch, book) in enumerate(
                zip(c.chunks, replay_codebooks(c.chunks, offline,
                                               bank=bank))):
            self.words.append(_u64_to_u32(ch.words))
            self.nbits.append(np.asarray(ch.block_nbits, np.int64))
            self.counts.append(int(ch.n_values))
            self.books.append(book)
            self.odelta.append(ch.outlier_delta)
            self.base.append(int(ch.center) if value else 0)
            self.islor.append(1 if chained else 0)
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
        base = np.zeros(c_cap, np.int32)           # value-direct centres
        base[:C] = np.asarray(self.base, np.int64).astype(np.int32)
        dev = self.device
        t = lambda a: torch.from_numpy(a).to(dev)
        fn = dispatch.resolve("ceaz_chunk_dec", self.kernel_impl, dev)
        with dispatch.measure("ceaz_chunk_dec", self.kernel_impl, dev):
            return fn(t(words2.view(np.int32)), t(nbits2), t(counts),
                      t(sym_flat), t(len_flat), t(cb_idx), t(odelta2),
                      t(base), t(seg0), t(islor), self.block_size)


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
    if getattr(c, "predictor", "lorenzo") == "none" or len(c.shape) == 1:
        # the rows are final q: value-direct centres added, or the flat
        # Lorenzo chain carried across the chunk boundaries, in the op
        q = rows.reshape(-1)[:n]
    else:
        q = _nd_cumsum(rows, c.ndim, n, _work_shape(c))
    return _finish_host(c, q.cpu().numpy(), np.float64(2.0 * c.chunks[0].eb))


def decompress_batch(comps: Sequence, block_size: int, offline: Codebook,
                     device="cuda", kernel_impl: str = "auto", bank=None
                     ) -> List[np.ndarray]:
    """Fused decode of a group of CEAZCompressed streams on `device`
    (the card unless the caller asks for the CPU): ONE `ceaz_chunk_dec`
    pass over every chunk of the group. Bank chunks resolve their book
    from `bank` when its id matches, else from the bank registry.
    Callers filter with :func:`fused_decode_ok` first (the facade
    does)."""
    batch = _ChunkBatch(block_size, target_device(device), kernel_impl)
    for c in comps:
        batch.add_comp(c, offline, bank=bank)
    if not batch.counts:
        return []
    q_all = batch.run_mega()
    return [decompress_one_mega(q_all[r0:r1], c)
            for c, (r0, r1) in zip(comps, batch.spans)]
