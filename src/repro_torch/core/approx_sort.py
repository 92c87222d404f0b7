"""Paper Algorithm 1: fast approximate sort exploiting Lorenzo symmetry.

The quant-code histogram produced by Lorenzo prediction + linear-scaling
quantization is (approximately) symmetric and unimodal around the centre
symbol (CEAZ Fig 7). Algorithm 1 therefore sorts symbol frequencies with a
single outward two-pointer sweep from the centre — O(n/2) comparisons — and
Huffman coding tolerates the approximation (the paper reports up to 27%
total-coding-time saving over radix sort; we verify the CR impact in
benchmarks/sort_latency.py).
"""
from __future__ import annotations

import numpy as np


def approx_sort_order(freqs: np.ndarray, center: int | None = None) -> np.ndarray:
    """Return symbol indices in ~ascending frequency order (paper Alg. 1).

    `freqs` is the full histogram (length n). The centre (most frequent)
    symbol lands at the END of the order; pairs (l, h) moving outwards are
    locally compared so each pair is correctly ordered. Vectorized: the
    outward sweep is a single elementwise compare + interleave — the host
    analogue of the FPGA's one-comparison-per-cycle pipeline (n/2 cycles).
    """
    freqs = np.asarray(freqs)
    n = len(freqs)
    if center is None:
        center = n // 2
    order = np.empty(n, dtype=np.int64)
    order[n - 1] = center
    npairs = min(center, n - 1 - center)
    l_idx = center - 1 - np.arange(npairs)
    h_idx = center + 1 + np.arange(npairs)
    le = freqs[l_idx] <= freqs[h_idx]
    hi_slot = np.where(le, h_idx, l_idx)       # larger of the pair
    lo_slot = np.where(le, l_idx, h_idx)
    # pair i occupies output slots (n-2-2i, n-3-2i)
    order[n - 2 - 2 * np.arange(npairs)] = hi_slot
    order[n - 3 - 2 * np.arange(npairs)] = lo_slot
    # CopyRemaining(A, O): one side may have leftover symbols
    j = n - 2 - 2 * npairs
    rem_l = center - 1 - npairs
    if rem_l >= 0:
        order[j - rem_l:j + 1] = np.arange(rem_l, -1, -1)[::-1]
    rem_h = (n - 1) - (center + npairs)
    if rem_h > 0:
        hs = np.arange(center + npairs + 1, n)
        order[j - rem_h + 1:j + 1] = hs[::-1]
    return order


def approx_sort_order_ref(freqs: np.ndarray,
                          center: int | None = None) -> np.ndarray:
    """Literal transcription of paper Algorithm 1 (oracle for tests)."""
    freqs = np.asarray(freqs)
    n = len(freqs)
    if center is None:
        center = n // 2
    order = np.empty(n, dtype=np.int64)
    order[n - 1] = center
    l, h = center - 1, center + 1
    j = n - 2
    while l >= 0 and h < n:
        if freqs[l] <= freqs[h]:
            order[j] = h
            order[j - 1] = l
        else:
            order[j] = l
            order[j - 1] = h
        j -= 2
        l -= 1
        h += 1
    while l >= 0:
        order[j] = l
        j -= 1
        l -= 1
    while h < n:
        order[j] = h
        j -= 1
        h += 1
    assert j == -1
    return order


def approx_sorted_nonzero(freqs: np.ndarray, center: int | None = None):
    """(symbols, freqs) with zero-frequency symbols filtered, ~ascending.

    The paper filters zero-frequency symbols before building the tree; we
    filter after the sweep (equivalent, and keeps the sweep branch-free).
    """
    order = approx_sort_order(freqs, center)
    keep = freqs[order] > 0
    syms = order[keep]
    return syms, np.asarray(freqs)[syms]
