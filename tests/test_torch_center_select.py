"""Numpy models of the two selections the card's kernels make, held on the
CPU against the port's plain versions and the JAX reference.

* The value-direct centre (``csrc/center.cu``): a range pass (m, the least
  and greatest valid key), then digit passes from the top of the row's
  range over the keys still in each middle rank's bucket: 13 bits while
  both ranks share a bucket (one histogram), else 12 bits a rank. The
  model counts its passes: a row spanning fewer than 2^13 keys takes one
  (buckets one key wide), a row spanning all of int32 three.
* The bank select (``csrc/bank.cu::select_row``): int32 costs summed with
  wrap, the first-occurrence argmin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dualquant import ops as RDO
from repro.kernels.megakernel import ref as RMR
from repro_torch.kernels.dualquant import ops as TDO
from repro_torch.kernels.megakernel import ops as TMK

KEY_BIAS = 0x80000000
DIGIT = 12
I32 = np.iinfo(np.int32)


def _wrap32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def _centre(lo_key: int, hi_key: int) -> int:
    """lo + floor((hi - lo) / 2) in int32 with wrap, from the two keys."""
    lo = _wrap32(lo_key ^ KEY_BIAS)
    hi = _wrap32(hi_key ^ KEY_BIAS)
    return _wrap32(lo + _wrap32(hi - lo) // 2)


def model_center(q: np.ndarray, valid: np.ndarray):
    """One row as center.cu selects it -> (centre, digit passes)."""
    keys = (q.astype(np.int64)[valid] & 0xFFFFFFFF) ^ KEY_BIAS
    m = keys.size
    if m == 0:
        return 0, 0
    kmin, kmax = int(keys.min()), int(keys.max())
    if kmin == kmax:
        return _centre(kmin, kmin), 0
    rank = [(m - 1) // 2, m // 2]          # both below m: valid keys only
    prefix = [0, 0]
    rel = keys - kmin
    sh = (kmax - kmin).bit_length()
    passes = 0
    while sh > 0:
        same = prefix[0] == prefix[1]      # one histogram: a digit wider
        sl = max(sh - DIGIT - same, 0)
        nb = 1 << (sh - sl)
        top, digit = rel >> sh, (rel >> sl) & (nb - 1)
        h0 = np.bincount(digit[top == prefix[0]], minlength=nb)
        h1 = h0 if same else np.bincount(digit[top == prefix[1]],
                                         minlength=nb)
        for r, h in enumerate((h0, h1)):
            cum = np.cumsum(h)
            b = int(np.searchsorted(cum, rank[r], side="right"))
            rank[r] -= int(cum[b - 1]) if b else 0
            prefix[r] = (prefix[r] << (sh - sl)) | b
        sh = sl
        passes += 1
    return _centre(kmin + prefix[0], kmin + prefix[1]), passes


def _hard_rows(seed: int, V: int):
    """m = 0, 1 and 2; all keys equal; duplicates straddling both middle
    ranks; valid INT32_MIN and INT32_MAX; a row spanning all of int32;
    hi - lo wrapping in int32; invalid entries holding extreme values."""
    rng = np.random.default_rng(seed)
    every = np.ones(V, bool)
    span = rng.integers(I32.min, I32.max, V, endpoint=True)
    span[:2] = (I32.min, I32.max)
    dup = np.where(np.arange(V) < V // 2, 4, 5)
    extreme = np.where(rng.random(V) < 0.5, I32.min, I32.max)
    narrow = rng.integers(-300, 300, V)
    wrap = np.zeros(V, np.int64)
    wrap[:2] = (-2_000_000_000, 2_000_000_000)
    rows = [(narrow, np.zeros(V, bool)), (span, np.arange(V) < 1),
            (span, np.arange(V) < 2), (np.full(V, -3), every),
            (dup, every), (np.concatenate([dup[:-1], [6]]), every),
            (np.where(np.arange(V) % 2 == 0, I32.min, I32.max), every),
            (span, every), (wrap, np.arange(V) < 2),
            (np.where(np.arange(V) % 3 == 0, narrow, extreme),
             np.arange(V) % 3 == 0),
            (rng.integers(-20000, 20000, V), rng.random(V) < 0.9)]
    return (np.stack([r for r, _ in rows]).astype(np.int64).astype(np.int32),
            np.stack([m for _, m in rows]))


def _model_rows(q2, valid2):
    return np.array([model_center(q, v)[0] for q, v in zip(q2, valid2)],
                    np.int32)


@pytest.mark.parametrize("V", [2, 5, 37, 300])
def test_center_model_matches_plain_and_reference_on_hard_rows(V):
    q2, valid2 = _hard_rows(V, V)
    want = TDO.chunk_center_plain(torch.from_numpy(q2),
                                  torch.from_numpy(valid2)).numpy()
    np.testing.assert_array_equal(_model_rows(q2, valid2), want)
    ref = np.asarray(RDO.dq_center(jnp.asarray(q2), jnp.asarray(valid2),
                                   interpret=True))
    np.testing.assert_array_equal(ref, want)


@pytest.mark.parametrize("seed", range(4))
def test_center_model_matches_plain_on_random_rows(seed):
    """Rows of random width, spread and valid prefix or mask."""
    rng = np.random.default_rng(100 + seed)
    C, V = 64, 257
    spread = 2 ** rng.integers(0, 33, C)
    centre = rng.integers(I32.min, I32.max, C, endpoint=True)
    q2 = np.clip(centre[:, None] + rng.integers(-1, 2, (C, V))
                 * (rng.random((C, V)) * spread[:, None]).astype(np.int64),
                 I32.min, I32.max).astype(np.int32)
    valid2 = np.where(rng.random(C)[:, None] < 0.5,
                      np.arange(V)[None, :] < rng.integers(0, V + 1, C)[:,
                                                                     None],
                      rng.random((C, V)) < rng.random(C)[:, None])
    want = TDO.chunk_center_plain(torch.from_numpy(q2),
                                  torch.from_numpy(valid2)).numpy()
    np.testing.assert_array_equal(_model_rows(q2, valid2), want)


@pytest.mark.parametrize("span,passes", [(1, 1), (4096, 1), (8191, 1),
                                         (8192, 2), (2**24, 2), (2**26 - 1, 2),
                                         (2**26, 3), (2**32 - 1, 3)])
def test_center_model_pass_count(span, passes):
    """Bucket width from the range: 13 bits while both ranks share a
    bucket, so a range below 2^13 is one pass of buckets one key wide and
    the whole int32 range three (with the range pass, four reads of the
    row). The three keys keep both ranks on the middle one."""
    lo = I32.min if span > I32.max else -(span // 2)
    q = np.array([lo, lo + span // 3, lo + span], np.int64).astype(np.int32)
    centre, got = model_center(q, np.ones(3, bool))
    assert got == passes
    assert centre == TDO.chunk_center_plain(
        torch.from_numpy(q[None]), torch.ones((1, 3), dtype=torch.bool))[0]


def test_center_model_on_value_direct_rows():
    """Value-direct q of a smooth field at rel eb 1e-3 spans ~10^3 keys
    (10^4 at 1e-4): one digit pass, buckets one key wide."""
    rng = np.random.default_rng(7)
    x = np.cumsum(rng.standard_normal(1 << 14)).astype(np.float32)
    eb = 1e-3 * float(x.max() - x.min())
    q = np.rint(x / (2 * eb)).astype(np.int32)
    centre, passes = model_center(q, np.ones(q.size, bool))
    assert passes == 1
    assert centre == TDO.chunk_center_plain(
        torch.from_numpy(q[None]), torch.ones((1, q.size), dtype=torch.bool))[0]


def model_select(hists: np.ndarray, lengths: np.ndarray):
    """select_row: a warp a book, lane partials over s = lane mod 32 in
    uint32, their wrapping sum as the int32 cost; the running argmin
    replaces only on a strictly smaller cost (the first minimum wins)."""
    h = hists.astype(np.uint32)
    sel, totals = [], []
    for row in h:
        low, arg = 0, 0
        for k, ln in enumerate(lengths.astype(np.uint32)):
            parts = [(row[lane::32] * ln[lane::32]).sum(dtype=np.uint32)
                     for lane in range(32)]
            cost = int(np.array(parts, np.uint32).sum(dtype=np.uint32)
                       .view(np.int32))
            if k == 0 or cost < low:
                low, arg = cost, k
        sel.append(arg)
        totals.append(low)
    return np.array(sel, np.int32), np.array(totals, np.int32)


@pytest.mark.parametrize("scale", [1 << 4, 1 << 12, 1 << 27])
def test_select_model_first_occurrence_under_wrap(scale):
    """Books that tie (copies of books 1 and 0 after the bank) and, at
    the largest scale, costs past 2^31 that wrap in int32."""
    from repro_torch.core.codebook import default_codebook_bank
    ln = default_codebook_bank().lengths.astype(np.int32)
    ln = np.concatenate([ln, ln[1:2], ln[:1]])
    rng = np.random.default_rng(scale)
    hists = rng.integers(0, scale, (12, 1024)).astype(np.int32)
    hists[0] = 0                                   # every book costs 0
    sel, totals = model_select(hists, ln)
    want = TMK.bank_select_plain(torch.from_numpy(hists), torch.from_numpy(ln),
                                 torch.from_numpy(ln))
    np.testing.assert_array_equal(sel, want[0].numpy())
    np.testing.assert_array_equal(totals, want[1].numpy())
    rsel, rtot = RMR.select_bank(jnp.asarray(hists), jnp.asarray(ln))
    np.testing.assert_array_equal(sel, np.asarray(rsel))
    np.testing.assert_array_equal(totals, np.asarray(rtot))
    assert sel[0] == 0
    assert sel.max() < 12                          # a copy never wins a tie
