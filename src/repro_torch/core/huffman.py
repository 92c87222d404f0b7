"""Canonical Huffman coding (host build + vectorized encode/decode).

Implements the paper's 7-step codeword generation (CEAZ Fig 3):
filter -> sort -> create tree -> compute bit length -> truncate tree ->
canonize tree -> create codewords — with two build strategies:

  * ``exact=True``  — heap-based optimal Huffman (the "ideal/online" oracle
    used for the orange bars in paper Fig 10 and the CPU-SZ comparison);
  * ``exact=False`` — paper path: Algorithm-1 approximate sort feeding a
    two-queue O(n) tree build (the FPGA-friendly structure).

Codebooks are *length-limited* (default L_max=16, the paper's "truncate
tree" step) with a Kraft fix-up, then canonized. Encoding is fully
vectorized numpy (bit-parallel word OR); decoding is table-driven and
vectorized ACROSS blocks (each block's bitstream is independent — the
per-block bit counts the encoder stores are exactly what lets the FPGA /
TPU decode pipelines run in parallel).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import heapq
from typing import Optional, Tuple

import numpy as np

from .approx_sort import approx_sorted_nonzero

NUM_SYMBOLS = 1024
DEFAULT_MAX_LEN = 16
_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# Tree build -> code lengths
# ---------------------------------------------------------------------------

def _lengths_exact(freqs: np.ndarray) -> np.ndarray:
    """Optimal Huffman code lengths via heap merge (oracle path)."""
    nz = np.flatnonzero(freqs)
    lengths = np.zeros(len(freqs), dtype=np.int64)
    if len(nz) == 0:
        return lengths
    if len(nz) == 1:
        lengths[nz[0]] = 1
        return lengths
    # heap of (freq, tiebreak, leaves) where leaves is list of symbols
    heap = [(int(freqs[s]), int(s), [int(s)]) for s in nz]
    heapq.heapify(heap)
    tie = NUM_SYMBOLS
    while len(heap) > 1:
        f1, _, l1 = heapq.heappop(heap)
        f2, _, l2 = heapq.heappop(heap)
        for s in l1:
            lengths[s] += 1
        for s in l2:
            lengths[s] += 1
        heapq.heappush(heap, (f1 + f2, tie, l1 + l2))
        tie += 1
    return lengths


def _lengths_twoqueue(syms: np.ndarray, freqs: np.ndarray,
                      n_total: int) -> np.ndarray:
    """Two-queue Huffman build from (approximately) ascending frequencies.

    Any merge order yields a *valid* prefix code; an approximately sorted
    input yields near-optimal lengths (the paper's trade). O(n).
    """
    lengths = np.zeros(n_total, dtype=np.int64)
    n = len(syms)
    if n == 0:
        return lengths
    if n == 1:
        lengths[syms[0]] = 1
        return lengths
    leaf_i = 0
    # internal node queue: (freq, member symbol list)
    internal: list[Tuple[int, list]] = []
    int_i = 0

    def pop_min():
        nonlocal leaf_i, int_i
        leaf_ok = leaf_i < n
        int_ok = int_i < len(internal)
        if leaf_ok and (not int_ok or freqs[leaf_i] <= internal[int_i][0]):
            item = (int(freqs[leaf_i]), [int(syms[leaf_i])])
            leaf_i += 1
            return item
        item = internal[int_i]
        int_i += 1
        return item

    remaining = n
    while remaining > 1:
        f1, l1 = pop_min()
        f2, l2 = pop_min()
        for s in l1:
            lengths[s] += 1
        for s in l2:
            lengths[s] += 1
        internal.append((f1 + f2, l1 + l2))
        remaining -= 1
    return lengths


def _truncate_lengths(lengths: np.ndarray, freqs: np.ndarray,
                      max_len: int) -> np.ndarray:
    """Length-limit the code ('truncate tree'): clamp + Kraft fix-up.

    After clamping to max_len the Kraft sum may exceed 1; we restore
    validity by lengthening the lowest-frequency codes (< max_len), then
    greedily shorten the highest-frequency codes while Kraft permits.
    """
    lengths = lengths.copy()
    used = lengths > 0
    lengths[used] = np.minimum(lengths[used], max_len)
    scale = 1 << max_len                       # integer Kraft in units 2^-max_len
    kraft = int(np.sum((scale >> lengths[used]).astype(np.int64)))
    if kraft > scale:
        # lengthen cheapest symbols first
        order = np.argsort(freqs + (~used) * np.int64(1 << 60), kind="stable")
        while kraft > scale:
            for s in order:
                if not used[s] or lengths[s] >= max_len:
                    continue
                gain = (scale >> lengths[s]) - (scale >> (lengths[s] + 1))
                lengths[s] += 1
                kraft -= gain
                if kraft <= scale:
                    break
    # greedy shorten most frequent symbols to use slack
    order_desc = np.argsort(-(freqs * used.astype(np.int64)), kind="stable")
    improved = True
    while improved:
        improved = False
        for s in order_desc:
            if not used[s] or lengths[s] <= 1:
                continue
            extra = (scale >> (lengths[s] - 1)) - (scale >> lengths[s])
            if kraft + extra <= scale:
                lengths[s] -= 1
                kraft += extra
                improved = True
    return lengths


def _canonize(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codes: symbols sorted by (length, symbol id)."""
    codes = np.zeros(len(lengths), dtype=np.uint32)
    used = np.flatnonzero(lengths)
    if len(used) == 0:
        return codes
    order = used[np.lexsort((used, lengths[used]))]
    code = 0
    prev_len = int(lengths[order[0]])
    for s in order:
        l = int(lengths[s])
        code <<= (l - prev_len)
        codes[s] = code
        code += 1
        prev_len = l
    return codes


@dataclasses.dataclass
class Codebook:
    """Canonical, length-limited Huffman codebook over NUM_SYMBOLS symbols."""
    lengths: np.ndarray                 # (S,) uint8; 0 => symbol unused
    codes: np.ndarray                   # (S,) uint32, right-aligned values
    max_len: int = DEFAULT_MAX_LEN
    _dec_sym: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    _dec_len: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_freqs(cls, freqs: np.ndarray, *, exact: bool = False,
                   max_len: int = DEFAULT_MAX_LEN,
                   smoothing: bool = True) -> "Codebook":
        """Build from a histogram. `smoothing` add-one-smooths so EVERY
        symbol gets a code — required because codebooks are reused on
        future chunks (adaptive policy) that may contain unseen symbols."""
        freqs = np.asarray(freqs, dtype=np.int64)
        if smoothing:
            freqs = freqs + 1
        if exact:
            lengths = _lengths_exact(freqs)
        else:
            syms, fs = approx_sorted_nonzero(freqs)
            lengths = _lengths_twoqueue(syms, fs, len(freqs))
        lengths = _truncate_lengths(lengths, freqs, max_len)
        codes = _canonize(lengths)
        return cls(lengths=lengths.astype(np.uint8), codes=codes,
                   max_len=max_len)

    @property
    def id(self) -> str:
        return hashlib.sha1(self.lengths.tobytes()).hexdigest()[:12]

    def storage_bits(self) -> int:
        """Bits to ship the codebook: canonical => lengths only (5b each)."""
        return 5 * len(self.lengths)

    def mean_bits(self, freqs: np.ndarray) -> float:
        """Expected bits/symbol of this codebook under histogram `freqs`."""
        freqs = np.asarray(freqs, dtype=np.float64)
        p = freqs / max(freqs.sum(), 1.0)
        return float(np.sum(p * self.lengths))

    # -- decode table --------------------------------------------------------
    def tables(self):
        """(dec_sym uint16, dec_len uint8) flat decode tables of size
        2**max_len — built once per Codebook instance and cached."""
        return self._tables()

    def _tables(self):
        if self._dec_sym is None:
            L = self.max_len
            sym = np.zeros(1 << L, dtype=np.uint16)
            ln = np.zeros(1 << L, dtype=np.uint8)
            for s in np.flatnonzero(self.lengths):
                l = int(self.lengths[s])
                lo = int(self.codes[s]) << (L - l)
                hi = lo + (1 << (L - l))
                sym[lo:hi] = s
                ln[lo:hi] = l
            self._dec_sym, self._dec_len = sym, ln
        return self._dec_sym, self._dec_len


@functools.lru_cache(maxsize=512)
def _codebook_from_lengths_cached(lengths_bytes: bytes) -> Codebook:
    lengths = np.frombuffer(lengths_bytes, dtype=np.uint8).copy()
    return Codebook(lengths=lengths, codes=_canonize(lengths.astype(np.int64)))


def codebook_from_lengths(lengths: np.ndarray) -> Codebook:
    """Reconstruct a canonical codebook from its shipped code lengths.

    Memoized on the lengths array: streams reuse the same few codebooks
    across many chunks (the whole point of the adaptive policy), so the
    canonize pass AND the 2**max_len decode tables (cached on the shared
    Codebook instance) are built once per distinct codebook — not per
    chunk, which dominated host decompression cost.
    """
    l8 = np.ascontiguousarray(np.asarray(lengths, dtype=np.uint8))
    return _codebook_from_lengths_cached(l8.tobytes())


def replay_codebooks(chunks, offline: Codebook, bank=None) -> list:
    """The decoder-side codebook sequence, exactly as the encoder chose
    it: bank chunks resolve their book from the referenced
    :class:`~repro_torch.core.codebook.CodebookBank` (the `bank` argument
    when its id matches, the process registry otherwise — stream
    readers register banks from footer meta), shipped lengths rebuild
    (memoized), 'offline' resets, everything else carries the previous
    book forward. Shared by the staged and fused decoders — the single
    source of the replay state machine."""
    books, current = [], offline
    for ch in chunks:
        bank_index = getattr(ch, "bank_index", -1)
        if bank_index >= 0:
            ref = getattr(ch, "bank_ref", "")
            b = bank
            if b is None or (ref and b.id != ref):
                from .codebook import lookup_bank   # lazy: no import cycle
                b = lookup_bank(ref)
            current = b.codebook(int(bank_index))
        elif ch.codebook_lengths is not None:
            current = codebook_from_lengths(ch.codebook_lengths)
        elif ch.action == "offline":
            current = offline
        books.append(current)
    return books


# ---------------------------------------------------------------------------
# Vectorized encode (bitstream pack) and block-parallel decode
# ---------------------------------------------------------------------------

def encode(symbols: np.ndarray, cb: Codebook, block_size: int = 4096
           ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pack symbols into an MSB-first bitstream.

    Returns (words uint64, block_nbits int64, total_bits). Block i's
    bitstream starts at bit offset sum(block_nbits[:i]) — block boundaries
    are bit-aligned; per-block counts enable parallel decode.
    """
    symbols = np.asarray(symbols).reshape(-1)
    lens = cb.lengths[symbols].astype(np.int64)
    if np.any(lens == 0):
        raise ValueError("codebook does not cover all present symbols")
    vals = cb.codes[symbols].astype(np.uint64)

    ends = np.cumsum(lens)
    starts = ends - lens
    total_bits = int(ends[-1]) if len(ends) else 0
    nwords = (total_bits + 63) // 64
    words = np.zeros(nwords + 1, dtype=np.uint64)

    word_idx = (starts >> 6).astype(np.int64)
    bitin = (starts & 63).astype(np.int64)
    left = 64 - bitin - lens                       # may be negative
    ls = np.clip(left, 0, 63).astype(np.uint64)
    rs = np.clip(-left, 0, 63).astype(np.uint64)
    hi = np.where(left >= 0, (vals << ls) & _M64, vals >> rs)
    lo_sh = np.clip(64 + left, 0, 63).astype(np.uint64)
    lo = np.where(left < 0, (vals << lo_sh) & _M64, np.uint64(0))
    np.add.at(words, word_idx, hi.astype(np.uint64))
    np.add.at(words, word_idx + 1, lo.astype(np.uint64))

    # per-block bit counts
    n = len(symbols)
    nblocks = max(1, (n + block_size - 1) // block_size)
    pad = nblocks * block_size - n
    lens_p = np.pad(lens, (0, pad))
    block_nbits = lens_p.reshape(nblocks, block_size).sum(axis=1)
    return words[:nwords + 1], block_nbits.astype(np.int64), total_bits


def _peek(words: np.ndarray, pos: np.ndarray, k: int) -> np.ndarray:
    """Vectorized K-bit MSB-first peek at bit positions `pos`."""
    w = (pos >> 6).astype(np.int64)
    b = (pos & 63).astype(np.uint64)
    x = (words[w] << b) & _M64
    y = np.where(b > 0, words[w + 1] >> (np.uint64(64) - np.maximum(b, 1)),
                 np.uint64(0))
    window = x | y
    return (window >> np.uint64(64 - k)).astype(np.int64)


def decode(words: np.ndarray, block_nbits: np.ndarray, n_total: int,
           block_size: int, cb: Codebook) -> np.ndarray:
    """Block-parallel table decode: python loop over IN-BLOCK position,
    vectorized over all blocks (mirrors the multi-pipeline FPGA decoder)."""
    dec_sym, dec_len = cb._tables()
    nblocks = len(block_nbits)
    starts = np.concatenate([[0], np.cumsum(block_nbits)[:-1]]).astype(np.int64)
    cursors = starts.copy()
    out = np.zeros((nblocks, block_size), dtype=np.uint16)
    counts = np.full(nblocks, block_size, dtype=np.int64)
    rem = n_total - (nblocks - 1) * block_size
    counts[-1] = rem
    # pad words so cursor+1 word reads stay in range
    words = np.concatenate([words, np.zeros(2, dtype=np.uint64)])
    for i in range(block_size):
        active = counts > i
        if not active.any():
            break
        pk = _peek(words, cursors, cb.max_len)
        sym = dec_sym[pk]
        ln = dec_len[pk].astype(np.int64)
        out[active, i] = sym[active]
        cursors += np.where(active, ln, 0)
    return out.reshape(-1)[:n_total]


def entropy_bits(freqs: np.ndarray) -> float:
    """Shannon entropy (bits/symbol) of a histogram — paper Eq. (1)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    total = freqs.sum()
    if total <= 0:
        return 0.0
    p = freqs[freqs > 0] / total
    return float(-np.sum(p * np.log2(p)))
