"""Decode parity: the port's table walk and `ceaz_chunk_dec` op (plain
versions — the ones the card's kernels are held against) vs the
reference's jnp walk / decode op and the Pallas decode megakernel
(interpret mode), on real streams in both regimes and on the decode
fuzz corpus. Every output is int32; comparisons are bitwise.

The reference's word-tiled Pallas walk (``hufdec_tiles``) does not
trace under the installed JAX (``pl.unblocked`` is gone), so the tiled
regime is held against the jnp reference on valid streams."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import huffman as RH
from repro.kernels.hufdec import ref as HDR
from repro.kernels.megakernel import decode_kernel as DK
from repro.kernels.megakernel import ref as MR
from repro.runtime.fused_decode import _u64_to_u32
from repro_torch.kernels import dispatch
from repro_torch.kernels.hufdec import ops as TH
from repro_torch.kernels.megakernel import ops as TM

CORPUS = os.path.join(os.path.dirname(__file__), "corpus",
                      "decode_fuzz_corpus.json")


def _stage(rng, counts, bs, zero_p=0.01, sigma=30):
    """Encode one random symbol row per count (own codebook each, code 0
    as the outlier escape) and stage them as the decode op's inputs."""
    rows_w, rows_nb, books, syms_all = [], [], [], []
    for k, n in enumerate(counts):
        syms = np.clip(rng.normal(512, sigma + 10 * k, n), 1, 1023) \
            .astype(np.int64)
        syms[rng.random(n) < zero_p] = 0
        cb = RH.Codebook.from_freqs(np.bincount(syms, minlength=1024))
        w64, bnb, _ = RH.encode(syms, cb, bs)
        rows_w.append(_u64_to_u32(w64))
        rows_nb.append(bnb)
        books.append(cb)
        syms_all.append(syms)
    C = len(counts)
    W = max(len(w) for w in rows_w) + 2
    NB = max(len(nb) for nb in rows_nb)
    words2 = np.zeros((C, W), np.uint32)
    nbits2 = np.zeros((C, NB), np.int32)
    for i in range(C):
        words2[i, :len(rows_w[i])] = rows_w[i]
        nbits2[i, :len(rows_nb[i])] = rows_nb[i]
    arrays = dict(
        words2=words2, nbits2=nbits2,
        counts=np.asarray(counts, np.int32),
        sym_flat=np.concatenate([b.tables()[0] for b in books]),
        len_flat=np.concatenate([b.tables()[1] for b in books]),
        cb_idx=np.arange(C, dtype=np.int32))
    return arrays, syms_all


def _torch(a):
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a.astype(
        np.int32 if a.dtype in (np.uint16, np.uint8) else a.dtype)))


def _walk_args(arrays):
    return [arrays[k] for k in ("words2", "nbits2", "counts", "sym_flat",
                                "len_flat", "cb_idx")]


@pytest.mark.parametrize("counts,bs", [([3], 512), ([511, 1], 512),
                                       ([4096, 700, 37], 512),
                                       ([33000, 20000], 256)])
def test_walk_matches_reference_walk(counts, bs):
    """Both window layouts of the port's walk (one window per row, and
    the word-tiled layout) decode real streams as the jnp walk does,
    zero padding past each count included."""
    rng = np.random.default_rng(sum(counts))
    arrays, syms = _stage(rng, counts, bs)
    ref = np.asarray(HDR.decode_blocks(
        *(jnp.asarray(a) for a in _walk_args(arrays)), bs)).astype(np.int32)
    targs = [_torch(a) for a in _walk_args(arrays)]
    W = arrays["words2"].shape[1]
    NB = arrays["nbits2"].shape[1]
    np.testing.assert_array_equal(
        TH.walk_plain(*targs, bs, NB, W).numpy(), ref)
    np.testing.assert_array_equal(TH.hufdec_tiles_plain(*targs, bs).numpy(),
                                  ref)
    for i, s in enumerate(syms):
        np.testing.assert_array_equal(ref[i, :len(s)], s)


def _dec_meta(rng, C, Ko):
    """Multi-row Lorenzo segments: rows 0..2 one chain, row 3 a value row
    (base 7), row 4 its own chain; odelta rows of Ko deltas (fewer than
    the escapes in some rows: the rank gather clamps)."""
    seg0 = np.array([0, 0, 0, 3, 4][:C], np.int32)
    islor = np.array([1, 1, 1, 0, 1][:C], np.int32)
    base = np.array([0, 0, 0, 7, 0][:C], np.int32)
    odelta2 = rng.integers(-2**31, 2**31, size=(C, Ko)).astype(np.int32)
    return dict(odelta2=odelta2, base=base, seg0=seg0, islor=islor)


@pytest.mark.parametrize("counts,bs,Ko", [
    ([4096, 4096, 1000, 3000, 17], 512, 64),      # fused regime
    ([512, 512, 512, 100, 512], 32, 4),           # fused, clamped ranks
    ([70000, 70000, 9000], 256, 2048),            # word-tiled regime
])
def test_ceaz_chunk_dec_matches_reference(counts, bs, Ko):
    rng = np.random.default_rng(len(counts) * bs)
    arrays, _ = _stage(rng, counts, bs)
    arrays.update(_dec_meta(rng, len(counts), Ko))
    args = [arrays[k] for k in ("words2", "nbits2", "counts", "sym_flat",
                                "len_flat", "cb_idx", "odelta2", "base",
                                "seg0", "islor")]
    ref = np.asarray(MR.ceaz_chunk_dec(*(jnp.asarray(a) for a in args),
                                       block_size=bs))
    op = dispatch.resolve("ceaz_chunk_dec", "auto", "cpu")
    port = op(*(_torch(a) for a in args), bs).numpy()
    np.testing.assert_array_equal(port, ref)
    NB = arrays["nbits2"].shape[1]
    if NB * bs <= TM.DEC_FUSE_LIMIT:
        pal = _pallas_fused(args, bs)
        np.testing.assert_array_equal(port, pal)


@pytest.mark.parametrize("rows_a_slice", [1, 2, 3, 5])
def test_patch_and_inverse_row_slices(rows_a_slice, monkeypatch):
    """The tail taken in row slices (a Lorenzo chain over rows 0..2 cut
    at every slice edge, a value row, a last chain) is bitwise the
    reference's one pass."""
    rng = np.random.default_rng(rows_a_slice)
    C, N, Ko = 5, 3000, 8
    codes2 = rng.integers(0, 1024, size=(C, N)).astype(np.int32)
    codes2[rng.random((C, N)) < 0.002] = 0
    counts = np.array([N, N, 2500, 1000, 17], np.int32)
    meta = _dec_meta(rng, C, Ko)
    args = [codes2, counts, meta["odelta2"], meta["base"], meta["seg0"],
            meta["islor"]]
    ref = np.asarray(MR.patch_and_inverse(*(jnp.asarray(a) for a in args)))
    monkeypatch.setattr(TM, "TAIL_VALUES", rows_a_slice * N)
    port = TM.patch_and_inverse(*(_torch(a) for a in args)).numpy()
    np.testing.assert_array_equal(port, ref)


def _pallas_fused(args, bs):
    (words2, nbits2, counts, sym_flat, len_flat, cb_idx, odelta2, base,
     seg0, islor) = args
    sym2 = jnp.asarray(sym_flat).reshape(-1, DK.TBL).astype(jnp.int32)
    len2 = jnp.asarray(len_flat).reshape(-1, DK.TBL).astype(jnp.int32)
    return np.asarray(DK.ceaz_chunk_dec_fused(
        jnp.asarray(words2), jnp.asarray(nbits2), jnp.asarray(counts),
        sym2, len2, jnp.asarray(cb_idx), jnp.asarray(odelta2),
        jnp.asarray(base), jnp.asarray(seg0), jnp.asarray(islor),
        block_size=bs, interpret=True))


def _garbage_cases():
    g = json.load(open(CORPUS))["garbage"]
    rng = np.random.default_rng(g["seed"])
    shapes = [(int(rng.integers(1, 4)), int(rng.integers(1, 7)), 32)
              for _ in range(g["cases"])]
    shapes.append((1, TM.DEC_FUSE_LIMIT // 256 + 8, 256))  # tiled regime
    for C, NB, bs in shapes:
        W = int(rng.integers(3, 24))
        yield bs, [rng.integers(0, 1 << 32, size=(C, W), dtype=np.uint32),
                   rng.integers(0, 1 << 12, size=(C, NB)).astype(np.int32),
                   rng.integers(0, NB * bs + 1, size=C).astype(np.int32),
                   rng.integers(0, 1024, size=(1 << 16,)).astype(np.uint16),
                   rng.integers(0, 17, size=(1 << 16,)).astype(np.uint8),
                   np.zeros(C, np.int32),
                   rng.integers(-999, 999, size=(C, 4)).astype(np.int32),
                   rng.integers(-5, 6, size=C).astype(np.int32),
                   np.zeros(C, np.int32),
                   rng.integers(0, 2, size=C).astype(np.int32)]


def test_fuzz_corpus_garbage_replay():
    """The corpus's garbage-bit cases (random words, tables with
    zero-length entries, random bit counts) through the port's decode op:
    it terminates with a well-shaped result, and in the fused regime its
    clamped walk decodes exactly what the Pallas megakernel decodes."""
    n_fused = 0
    for bs, args in _garbage_cases():
        C, NB = args[1].shape
        port = TM.ceaz_chunk_dec_plain(*(_torch(a) for a in args),
                                       bs).numpy()
        assert port.shape == (C, NB * bs) and port.dtype == np.int32
        if NB * bs <= TM.DEC_FUSE_LIMIT:
            np.testing.assert_array_equal(port, _pallas_fused(args, bs))
            n_fused += 1
    assert n_fused == 5


def test_fuzz_corpus_bitflips_through_the_walk():
    """The corpus's bitflip cases (record-relative payload offsets), each
    applied to one chunk row's payload: the port's decode op and the
    Pallas megakernel decode the corrupted row identically."""
    corpus = json.load(open(CORPUS))
    cases = [c for c in corpus["cases"] if c["kind"] == "bitflip"]
    rng = np.random.default_rng(corpus["random"]["seed"])
    for _ in range(corpus["random"]["n_bitflips"]):
        cases.append({"record": int(rng.integers(3)),
                      "rel_off": int(rng.integers(1 << 16)),
                      "bit": int(rng.integers(8))})
    bs = 512
    arrays, _ = _stage(np.random.default_rng(3), [4096, 3000, 1500], bs)
    arrays.update(_dec_meta(np.random.default_rng(4), 3, 32))
    keys = ("words2", "nbits2", "counts", "sym_flat", "len_flat", "cb_idx",
            "odelta2", "base", "seg0", "islor")
    for case in cases:
        words = arrays["words2"].copy()
        r = case["record"] % words.shape[0]
        payload = words[r].view(np.uint8)
        payload[case["rel_off"] % payload.size] ^= 1 << (case["bit"] & 7)
        args = [words if k == "words2" else arrays[k] for k in keys]
        port = TM.ceaz_chunk_dec_plain(*(_torch(a) for a in args),
                                       bs).numpy()
        np.testing.assert_array_equal(port, _pallas_fused(args, bs),
                                      err_msg=str(case))
