"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case here needs an NVIDIA GPU with nvcc (the kernels are built at
first use) and skips elsewhere. This file imports no JAX, so it runs on
a machine that has PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

All compared outputs are integers (or floats rebuilt from integers), so
every comparison is bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import CEAZ, CEAZConfig, default_offline_codebook
from repro_torch.core.huffman import Codebook
from repro_torch.data import fields as F
from repro_torch.kernels import dispatch
from repro_torch.kernels.dualquant import ops as DQ
from repro_torch.kernels.histogram import ops as HG
from repro_torch.kernels.hufdec import ops as HD
from repro_torch.kernels.hufenc import ops as HE
from repro_torch.kernels.megakernel import ops as MK

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _eq(a, b):
    a = [t.cpu() for t in (a if isinstance(a, (tuple, list)) else [a])]
    b = [t.cpu() for t in (b if isinstance(b, (tuple, list)) else [b])]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
    flat = x.reshape(-1)
    flat[::97] = np.nan
    flat[5::131] = np.inf
    flat[7::173] = -np.inf
    flat[11::211] = 3e9
    flat[13::223] = -3e9
    return x


@pytest.mark.parametrize("shape", [(12345,), (37, 1000), (1800, 7)])
def test_dualquant_kernel_matches_plain(dev, shape):
    x = _field(shape, 0)
    for eb in (1e-3, 0.37):
        work = torch.from_numpy(x).to(dev)
        n_out = x.size + 999
        got = DQ.dual_quantize_cuda(work, eb, len(shape), n_out)
        _eq(got, DQ.dual_quantize_plain(work, eb, len(shape), n_out))
        _eq(got, DQ.dual_quantize_plain(work.cpu(), eb, len(shape), n_out))


def _books(rng, C):
    books = [Codebook.from_freqs(rng.integers(0, 1000, 1024) ** 2)
             for _ in range(C)]
    ln = np.stack([b.lengths for b in books]).astype(np.int32)
    cw = np.stack([b.codes for b in books]).astype(np.int32)
    return books, ln, cw


@pytest.mark.parametrize("cv,bs", [(10000, 4096), (5000, 512), (70, 32)])
def test_hufenc_kernel_matches_plain(dev, cv, bs):
    rng = np.random.default_rng(1)
    C = 3
    _, ln, cw = _books(rng, C)
    codes = rng.integers(0, 1024, size=(C, cv)).astype(np.int32)
    valid = np.ones((C, cv), bool)
    valid[-1, cv // 3:] = False                       # ragged last row
    args = [torch.from_numpy(a).to(dev) for a in (codes, valid, ln, cw)]
    for w32 in (4, 96, 2 * (16 * cv // 64 + 1)):      # truncated .. full
        got = HE.encode_pack_cuda(*args, bs, w32)
        _eq(got, HE.encode_pack_plain(*args, bs, w32))
        _eq(got, HE.encode_pack_plain(*[a.cpu() for a in args], bs, w32))


def _garbage(rng, C, NB, W):
    return dict(
        words2=rng.integers(-2**31, 2**31, size=(C, W)).astype(np.int32),
        nbits2=rng.integers(0, 1 << 12, size=(C, NB)).astype(np.int32),
        counts=rng.integers(0, NB * 256 + 1, size=C).astype(np.int32),
        sym_flat=rng.integers(0, 1024, size=1 << 17).astype(np.int32),
        len_flat=rng.integers(0, 17, size=1 << 17).astype(np.int32),
        cb_idx=rng.integers(0, 2, size=C).astype(np.int32),
        odelta2=rng.integers(-999, 999, size=(C, 4)).astype(np.int32),
        base=rng.integers(-5, 6, size=C).astype(np.int32),
        seg0=np.zeros(C, np.int32),
        islor=rng.integers(0, 2, size=C).astype(np.int32))


@pytest.mark.parametrize("C,NB,bs", [(3, 6, 256), (2, 600, 256)])
def test_decode_kernels_match_plain_on_garbage(dev, C, NB, bs):
    """Random words/tables/bit counts: the clamped walk of both regimes
    (fused rows and word tiles) agrees with the plain version."""
    rng = np.random.default_rng(2)
    g = _garbage(rng, C, NB, int(rng.integers(3, 40)))
    args = [torch.from_numpy(v).to(dev) for v in g.values()]
    _eq(MK.ceaz_chunk_dec_cuda(*args, bs),
        MK.ceaz_chunk_dec_plain(*args, bs))
    _eq(HD.hufdec_tiles_cuda(*args[:6], bs),
        HD.hufdec_tiles_plain(*args[:6], bs))


@pytest.mark.parametrize("name,kw", [
    ("cesm", dict(mode="rel", eb=1e-4)),
    ("hacc", dict(mode="abs", eb=1e-3, chunk_bytes=1 << 16)),
    ("s3d", dict(mode="rel", eb=1e-4)),
])
def test_round_trip_on_card_matches_cpu(dev, name, kw):
    x = getattr(F, name + "_proxy")(size="small")
    off = default_offline_codebook()
    dispatch.reset_launches()
    gpu = CEAZ(CEAZConfig(device="cuda", **kw), offline_codebook=off)
    cpu = CEAZ(CEAZConfig(device="cpu", **kw), offline_codebook=off)
    cg, cc = gpu.compress(x), cpu.compress(x)
    for a, b in zip(cg.chunks, cc.chunks):
        assert np.array_equal(a.words, b.words)
        assert np.array_equal(a.block_nbits, b.block_nbits)
        assert np.array_equal(a.outlier_idx, b.outlier_idx)
        assert np.array_equal(a.outlier_delta, b.outlier_delta)
        assert a.codebook_id == b.codebook_id
    assert np.array_equal(cg.literal_idx, cc.literal_idx)
    yg, yc = gpu.decompress(cg), cpu.decompress(cc)
    assert yg.tobytes() == yc.tobytes()
    assert all(v > 0 for v in dispatch.launches().values())


# ---------------------------------------------------------------------------
# Bank encode and value-direct kernels (csrc/bank.cu, csrc/center.cu)
# ---------------------------------------------------------------------------

def _center_rows(seed, V):
    i32 = np.iinfo(np.int32)
    rng = np.random.default_rng(seed)
    edge = rng.choice([i32.min, i32.min + 1, i32.max - 1, i32.max], V)
    wrap = np.zeros(V, np.int64)
    wrap[:2] = (-2_000_000_000, 2_000_000_000)
    rows = [rng.integers(-5, 6, V), rng.integers(-1000, 1000, V),
            rng.integers(-1000, 1000, V), wrap, edge, edge,
            rng.integers(i32.min, i32.max, V, endpoint=True), np.full(V, 7)]
    masks = [np.ones(V, bool), np.arange(V) < V - 1097, np.zeros(V, bool),
             np.arange(V) < 2, np.ones(V, bool), rng.random(V) < 0.5,
             np.arange(V) < 1, np.arange(V) < 2]
    return (np.stack(rows).astype(np.int64).astype(np.int32),
            np.stack(masks))


@pytest.mark.parametrize("V", [4096, 70001, (1 << 20) + 3])
def test_dq_center_kernel_matches_plain(dev, V):
    q2, valid2 = (torch.from_numpy(a).to(dev) for a in _center_rows(3, V))
    got = DQ.dq_center_cuda(q2, valid2)
    _eq(got, DQ.chunk_center_plain(q2, valid2))
    _eq(got, DQ.chunk_center_plain(q2.cpu(), valid2.cpu()))


def _bank_rows(dev, C, cv, n_valid, seed):
    rng = np.random.default_rng(seed)
    flat = np.cumsum(rng.standard_normal(C * cv)).astype(np.float32)
    flat[::977] = np.nan
    flat[3::1601] = np.inf
    flat[5::2003] = -3e9
    flat[n_valid:] = 0.0
    valid = (np.arange(C * cv) < n_valid).reshape(C, cv)
    prev = np.zeros(C, np.float32)
    if cv:
        prev[1:] = flat[np.arange(1, C) * cv - 1]
    ebs = np.linspace(0.01, 0.3, C).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(flat.reshape(C, cv)), t(prev[:, None]), t(valid), t(ebs)


def _bank_tables(dev):
    from repro_torch.core.codebook import default_codebook_bank
    bank = default_codebook_bank()
    return (torch.from_numpy(bank.lengths.astype(np.int32)).to(dev),
            torch.from_numpy(bank.code_table().astype(np.uint32)
                             .view(np.int32)).to(dev))


@pytest.mark.parametrize("C,cv,n_valid", [(3, 4096, 2 * 4096 + 1500),
                                          (2, (1 << 17) + 4097, 200001),
                                          (3, 0, 0)])
def test_bank_quant_kernels_match_plain(dev, C, cv, n_valid):
    work2, prev2, valid2, ebs = _bank_rows(dev, C, cv, n_valid, 4)
    got = MK.lorenzo_quant_cuda(work2, prev2, valid2, ebs)
    _eq(got, MK.lorenzo_quant_plain(work2, prev2, valid2, ebs))
    _eq(got, MK.lorenzo_quant_plain(*(a.cpu() for a in
                                      (work2, prev2, valid2, ebs))))
    q2 = MK.value_quant_cuda(work2, ebs)
    _eq(q2, MK.value_quant_plain(work2, ebs))
    centers = DQ.dq_center_cuda(q2, valid2)
    got = MK.value_finalize_cuda(q2, valid2, centers)
    _eq(got, MK.value_finalize_plain(q2, valid2, centers))


def test_bank_select_kernel_matches_plain_with_ties(dev):
    ln, cw = _bank_tables(dev)
    ln = torch.cat([ln[:2], ln[1:2], ln[:1]])          # books 1, 2 and 0, 3 tie
    cw = torch.cat([cw[:2], cw[1:2], cw[:1]])
    rng = np.random.default_rng(5)
    hists = rng.integers(0, 1 << 12, (9, 1024)).astype(np.int32)
    hists[0] = 0
    hists = torch.from_numpy(hists).to(dev)
    got = MK.bank_select_cuda(hists, ln.contiguous(), cw.contiguous())
    _eq(got, MK.bank_select_plain(hists, ln, cw))
    assert set(got[0].cpu().tolist()) <= {0, 1}


@pytest.mark.parametrize("predictor", ["lorenzo", "value"])
@pytest.mark.parametrize("C,cv,n_valid", [(3, 4096, 2 * 4096 + 1500),
                                          (1, (1 << 17) + 4097, 140000)])
def test_ceaz_chunk_op_matches_plain(dev, predictor, C, cv, n_valid):
    work2, prev2, valid2, ebs = _bank_rows(dev, C, cv, n_valid, 6)
    ln, cw = _bank_tables(dev)
    for bits in (8, 16):
        w32 = 2 * ((cv * bits + 63) // 64 + 1)
        args = (work2, prev2, valid2, ebs, ln, cw, 1024, w32, predictor)
        _eq(MK.ceaz_chunk_cuda(*args), MK.ceaz_chunk_plain(*args))


def _center_hard_rows(seed, V):
    """Rows that take every branch of center.cu's select: m = 0, 1 and 2;
    all keys equal; duplicates straddling both middle ranks; valid
    INT32_MIN and INT32_MAX; a row spanning all of int32 (every digit
    pass); hi - lo wrapping in int32; invalid entries holding extreme
    values around a narrow valid range."""
    i32 = np.iinfo(np.int32)
    rng = np.random.default_rng(seed)
    every = np.ones(V, bool)
    span = rng.integers(i32.min, i32.max, V, endpoint=True)
    span[:2] = (i32.min, i32.max)
    dup = np.where(np.arange(V) < V // 2, 4, 5)
    extreme = np.where(rng.random(V) < 0.5, i32.min, i32.max)
    narrow = rng.integers(-300, 300, V)
    wrap = np.zeros(V, np.int64)
    wrap[:2] = (-2_000_000_000, 2_000_000_000)
    rows = [(narrow, np.zeros(V, bool)), (span, np.arange(V) < 1),
            (span, np.arange(V) < 2), (np.full(V, -3), every),
            (dup, every), (np.concatenate([dup[:-1], [6]]), every),
            (np.where(np.arange(V) % 2 == 0, i32.min, i32.max), every),
            (span, every), (wrap, np.arange(V) < 2),
            (np.where(np.arange(V) % 3 == 0, narrow, extreme),
             np.arange(V) % 3 == 0),
            (rng.integers(-20000, 20000, V), rng.random(V) < 0.9)]
    return (np.stack([r for r, _ in rows]).astype(np.int64).astype(np.int32),
            np.stack([m for _, m in rows]))


@pytest.mark.parametrize("C,V", [(70000, 37), (70000, 4100), (11, 1 << 23),
                                 (11, 4096), (11, 4097)])
def test_dq_center_kernel_on_hard_rows(dev, C, V):
    """The hard rows tiled over C rows: one-tile rows, multi-tile rows with scalar loads (V not a multiple of 16) and a full
    2^23 row with vector loads; more rows than a grid's y dimension."""
    q, v = _center_hard_rows(8, V)
    reps = -(-C // q.shape[0])
    q2 = torch.from_numpy(np.tile(q, (reps, 1))[:C]).to(dev)
    valid2 = torch.from_numpy(np.tile(v, (reps, 1))[:C]).to(dev)
    dispatch.reset_launches()
    got = DQ.dq_center_cuda(q2, valid2)
    assert dispatch.launches() == {"dq_center": 1}
    _eq(got, DQ.chunk_center_plain(q2, valid2))


def _tied_bank(dev):
    """The default bank and two copies of its books 1 and 0 after it:
    every row's cost ties between a book and its copy."""
    ln, cw = _bank_tables(dev)
    return (torch.cat([ln, ln[1:2], ln[:1]]).contiguous(),
            torch.cat([cw, cw[1:2], cw[:1]]).contiguous())


@pytest.mark.parametrize("predictor", ["lorenzo", "value"])
@pytest.mark.parametrize("C,cv,bs", [(64, 1 << 17, 4096), (1, 1 << 23, 4096),
                                     (70000, 48, 16), (5, 4096 * 3 + 7, 512),
                                     (5, 0, 512)])
def test_ceaz_chunk_op_at_main_path_shapes(dev, predictor, C, cv, bs):
    """The op at phase C's and D's shapes, at 70000 short rows, at
    unaligned rows and at rows of no values, with rows holding no valid
    value, partial rows and a bank whose books tie: bitwise against the plain version, in one
    quantize launch with the select folded in (no bank_select launch)."""
    work2, prev2, _, ebs = _bank_rows(dev, C, cv, C * cv, 9)
    lens = np.full(C, cv)
    lens[3::7] = 0
    lens[5::11] = cv // 3
    if C == 1:
        lens[0] = cv - 3
    valid2 = torch.from_numpy(np.arange(cv)[None, :] < lens[:, None]).to(dev)
    ln, cw = _tied_bank(dev)
    args = (work2, prev2, valid2, ebs, ln, cw, bs,
            2 * ((cv * 16 + 63) // 64 + 1), predictor)
    dispatch.reset_launches()
    got = MK.ceaz_chunk_cuda(*args)
    launched = dispatch.launches()
    assert "bank_select" not in launched
    assert launched.get("dq_center", 0) == (predictor == "value" and cv > 0)
    _eq(got, MK.ceaz_chunk_plain(*args))


def test_bank_quant_kernels_over_65535_rows(dev):
    """The three quantize modes and the bank select at 70000 rows (more
    than a grid's y dimension), one short unaligned row each."""
    C, cv = 70000, 37
    work2, prev2, valid2, ebs = _bank_rows(dev, C, cv, C * cv - 100, 10)
    got = MK.lorenzo_quant_cuda(work2, prev2, valid2, ebs)
    _eq(got, MK.lorenzo_quant_plain(work2, prev2, valid2, ebs))
    q2 = MK.value_quant_cuda(work2, ebs)
    _eq(q2, MK.value_quant_plain(work2, ebs))
    centers = DQ.dq_center_cuda(q2, valid2)
    got = MK.value_finalize_cuda(q2, valid2, centers)
    _eq(got, MK.value_finalize_plain(q2, valid2, centers))
    ln, cw = _tied_bank(dev)
    _eq(MK.bank_select_cuda(got[4], ln, cw),
        MK.bank_select_plain(got[4], ln, cw))


@pytest.mark.parametrize("predictor,kw", [
    ("lorenzo", dict(mode="rel", eb=1e-4, chunk_bytes=1 << 16)),
    ("none", dict(mode="abs", eb=1e-3)),
    ("auto", dict(mode="rel", eb=1e-3, chunk_bytes=1 << 16)),
])
def test_bank_round_trip_on_card_matches_cpu(dev, predictor, kw):
    off = default_offline_codebook()
    for name in ("hacc", "cesm"):
        x = getattr(F, name + "_proxy")(size="small")
        dispatch.reset_launches()
        gpu = CEAZ(CEAZConfig(device="cuda", codebook="bank",
                              predictor=predictor, **kw),
                   offline_codebook=off)
        cpu = CEAZ(CEAZConfig(device="cpu", codebook="bank",
                              predictor=predictor, **kw),
                   offline_codebook=off)
        cg, cc = gpu.compress(x), cpu.compress(x)
        assert cg.predictor == cc.predictor
        for a, b in zip(cg.chunks, cc.chunks):
            assert np.array_equal(a.words, b.words)
            assert np.array_equal(a.block_nbits, b.block_nbits)
            assert np.array_equal(a.outlier_idx, b.outlier_idx)
            assert np.array_equal(a.outlier_delta, b.outlier_delta)
            assert (a.codebook_id, a.bank_index, a.center) \
                == (b.codebook_id, b.bank_index, b.center)
        assert np.array_equal(cg.literal_idx, cc.literal_idx)
        assert gpu.decompress(cg).tobytes() == cpu.decompress(cc).tobytes()
        assert all(v > 0 for v in dispatch.launches().values())


# ---------------------------------------------------------------------------
# The split route's walk (the warp walk with one window a row) and
# fixed-ratio mode
# ---------------------------------------------------------------------------

def _valid_walk_args(dev, counts, bs, seed):
    """Rows of random symbols, each encoded with its own codebook."""
    from repro_torch.core.huffman import encode
    from repro_torch.runtime.fused_decode import _u64_to_u32
    rng = np.random.default_rng(seed)
    rows, nbs, books = [], [], []
    for k, n in enumerate(counts):
        syms = np.clip(rng.normal(512, 20 + 10 * k, n), 0, 1023) \
            .astype(np.int64)
        book = Codebook.from_freqs(np.bincount(syms, minlength=1024))
        w64, bnb, _ = encode(syms, book, bs)
        rows.append(_u64_to_u32(w64))
        nbs.append(bnb)
        books.append(book)
    C = len(counts)
    words2 = np.zeros((C, max(len(w) for w in rows) + 2), np.uint32)
    nbits2 = np.zeros((C, max(len(b) for b in nbs)), np.int32)
    for i in range(C):
        words2[i, :len(rows[i])] = rows[i]
        nbits2[i, :len(nbs[i])] = nbs[i]
    arrays = (words2.view(np.int32), nbits2, np.asarray(counts, np.int32),
              np.concatenate([b.tables()[0] for b in books]).astype(np.int32),
              np.concatenate([b.tables()[1] for b in books]).astype(np.int32),
              np.arange(C, dtype=np.int32))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.parametrize("counts,bs", [([4096, 700, 37], 512),
                                       ([200000, 131072, 5], 4096),
                                       ([70000] * 3, 1024)])
def test_hufdec_kernel_matches_plain(dev, counts, bs):
    """Valid streams (rows of many blocks, tail counts) and random
    garbage: the warp walk with one window a row agrees with the plain
    version bitwise."""
    args = _valid_walk_args(dev, counts, bs, 7)
    got = HD.hufdec_cuda(*args, bs)
    _eq(got, HD.hufdec_plain(*args, bs))
    _eq(got, HD.hufdec_plain(*[a.cpu() for a in args], bs))
    rng = np.random.default_rng(8)
    g = _garbage(rng, 3, 70, int(rng.integers(3, 40)))
    garbage = [torch.from_numpy(v).to(dev) for v in g.values()][:6]
    _eq(HD.hufdec_cuda(*garbage, 256), HD.hufdec_plain(*garbage, 256))


@pytest.mark.parametrize("codebook", ["exact", "bank"])
def test_fixed_ratio_round_trip_on_card_matches_cpu(dev, codebook):
    """Fixed-ratio mode (speculation 'auto') on the card equals the CPU
    run field for field, and decodes through both routes to the same
    bytes."""
    x = F.hacc_proxy(size="small")[:-1000]
    off = default_offline_codebook()
    kw = dict(mode="fixed_ratio", target_ratio=10.0, chunk_bytes=1 << 14,
              codebook=codebook)
    dispatch.reset_launches()
    gpu = CEAZ(CEAZConfig(device="cuda", **kw), offline_codebook=off)
    cpu = CEAZ(CEAZConfig(device="cpu", **kw), offline_codebook=off)
    cg, cc = gpu.compress(x), cpu.compress(x)
    assert len(cg.chunks) == len(cc.chunks) > 1
    for a, b in zip(cg.chunks, cc.chunks):
        assert a.eb == b.eb and a.action == b.action
        assert np.array_equal(a.words, b.words)
        assert np.array_equal(a.block_nbits, b.block_nbits)
        assert np.array_equal(a.outlier_idx, b.outlier_idx)
        assert np.array_equal(a.outlier_delta, b.outlier_delta)
        assert (a.codebook_id, a.bank_index) == (b.codebook_id, b.bank_index)
    assert np.array_equal(cg.literal_idx, cc.literal_idx)
    want = cpu.decompress(cc).tobytes()
    assert gpu.decompress(cg).tobytes() == want
    split = CEAZ(CEAZConfig(device="cuda", decode_megakernel="split", **kw),
                 offline_codebook=off)
    assert split.decompress(cg).tobytes() == want
    launched = dispatch.launches()
    assert launched.get("ceaz_chunk_fused", 0) > 0
    assert launched.get("hufdec", 0) == 1
    assert launched.get("gather_pack_tiled", 0) > 0


# -- bitpack and the fixed-width wire path ---------------------------------------

def _eq_nan(a, b):
    """Bitwise where not NaN, NaN at the same places: the card makes the
    canonical NaN where x86 propagates an operand's payload."""
    a, b = a.cpu(), b.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape
    na, nb = torch.isnan(a), torch.isnan(b)
    assert torch.equal(na, nb)
    assert torch.equal(a[~na].view(torch.int32), b[~nb].view(torch.int32))


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
@pytest.mark.parametrize("n", [1, 4097, 1000003])
def test_bitpack_kernels_match_plain(dev, bits, n):
    """Both layouts, random codes with out-of-range values (the mask), on
    lengths that are multiples of neither per nor the tile; against the
    plain versions on the card and on the CPU. A misaligned view takes
    the kernels' scalar path."""
    from repro_torch.kernels.bitpack import ops as BP
    rng = np.random.default_rng(n + bits)
    v = rng.integers(-(1 << 20), 1 << 20, n + 1).astype(np.int32)
    v[::3] &= (1 << bits) - 1
    for q in (torch.from_numpy(v[:n]).to(dev),
              torch.from_numpy(v).to(dev)[1:]):
        for cuda_fn, plain_fn in ((BP.pack_words_cuda, BP.pack_words_plain),
                                  (BP.pack_flat_cuda, BP.pack_flat_plain)):
            words = cuda_fn(q, bits)
            _eq(words, plain_fn(q, bits))
            _eq(words, plain_fn(q.cpu(), bits))
        w = BP.pack_words_cuda(q, bits)
        _eq(BP.unpack_words_cuda(w, n, bits),
            BP.unpack_words_plain(w.cpu(), n, bits))
        t = BP.pack_flat_cuda(q, bits)
        _eq(BP.unpack_flat_cuda(t, n, bits),
            BP.unpack_flat_plain(t.cpu(), n, bits))
        _eq(BP.unpack_cuda(t, bits), BP.unpack_plain(t.cpu(), bits))
        tile = BP.unpack_cuda(t, bits)
        _eq(BP.pack_cuda(tile, bits), BP.pack_plain(tile.cpu(), bits))


@pytest.mark.parametrize("lor", [True, False])
def test_compressed_all_gather_on_card_matches_cpu(dev, lor):
    """A small gather with a NaN and an Inf rank: pack and unpack launch
    on the card; the non-Lorenzo decode equals the CPU run's bytes, the
    Lorenzo decode the same NaN pattern and within the scan bound."""
    from repro_torch.io import collectives as COL
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.standard_normal((3, 10001)), axis=1).astype(np.float32)
    x[1, 77] = np.nan
    x[2, 5] = np.inf
    for bits in (8, 4):
        wire = COL.WireFormat(bits, lor)
        dispatch.reset_launches()
        got = COL.compressed_all_gather(x, wire, device="cuda")
        torch.cuda.synchronize()
        counts = dispatch.launches()
        assert counts.get("pack") == 1 and counts.get("unpack") == 1
        want = COL.compressed_all_gather(x, wire, device="cpu")
        got = got.cpu()
        if not lor:
            _eq_nan(got, want)
            continue
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        words, scale = COL._encode_local(torch.from_numpy(x[:1]), bits, lor)
        from repro_torch.optim import grad_compress as GC
        codes = GC.BP.unpack_words(words, x.shape[1], bits)
        rh = GC.dequantize_rows(codes[None], scale, bits)[0].numpy()
        S, scan, _ = COL.lorenzo_bounds(x[0], rh, float(scale[0]),
                                        COL.sqrt_block(x.shape[1]))
        assert np.all(np.abs(got[0].numpy().astype(np.float64) - S) <= scan)


def test_cross_pod_mean_on_card_matches_cpu(dev):
    """Two steps of the exchange with a NaN leaf and an Inf leaf: means
    and residuals equal the CPU run's bytes."""
    from repro_torch.optim import grad_compress as GC
    rng = np.random.default_rng(4)
    grads = {k: torch.from_numpy(rng.standard_normal((4,) + s).astype(
        np.float32)) for k, s in (("w", (33, 70)), ("nan", (129,)),
                                  ("inf", (3, 5)), ("b", (7,)))}
    grads["nan"][2, 3] = float("nan")
    grads["inf"][0, 1, 1] = float("-inf")
    cfg = GC.CompressionConfig(bits=8)
    res_g = GC.ef_init(grads, device="cuda")
    res_c = GC.ef_init(grads, device="cpu")
    for _ in range(2):
        mean_g, res_g = GC.compressed_cross_pod_mean(grads, res_g, cfg)
        mean_c, res_c = GC.compressed_cross_pod_mean(grads, res_c, cfg,
                                                     device="cpu")
        for k in grads:
            _eq_nan(mean_g[k], mean_c[k])
            _eq_nan(res_g[k], res_c[k])
    assert torch.isnan(mean_g["nan"]).all() and torch.isnan(
        mean_g["inf"]).all()


@pytest.mark.parametrize("C,n", [(1, 1), (1, 1000), (3, 65536), (70000, 3),
                                 (2, 100003)])
def test_histogram_kernel_matches_plain(dev, C, n):
    """Skewed rows (half the codes at 512), invalid positions and codes
    outside [0, 1024) that must count nowhere; C past the grid's y
    limit."""
    rng = np.random.default_rng(n)
    codes = rng.normal(512, 3, (C, n)).astype(np.int32)
    codes[:, ::2] = 512
    codes[:, 5::17] = rng.choice([-1, 1024, 5000, -7], codes[:, 5::17].shape)
    valid = rng.random((C, n)) < 0.9
    c, v = torch.from_numpy(codes).to(dev), torch.from_numpy(valid).to(dev)
    got = HG.histogram_cuda(c, v)
    _eq(got, HG.histogram_plain(c, v))
    _eq(got, HG.histogram_plain(c.cpu(), v.cpu()))


@pytest.mark.parametrize("cv,bs", [(1, 4096), (65536, 4096), (5000, 16),
                                   (70001, 1000)])
def test_gather_pack_kernel_matches_plain(dev, cv, bs):
    rng = np.random.default_rng(cv)
    C = 3
    _, ln, cw = _books(rng, C)
    codes = rng.integers(0, 1024, size=(C, cv)).astype(np.int32)
    valid = rng.random((C, cv)) < 0.95
    args = [torch.from_numpy(a).to(dev) for a in (codes, valid, ln, cw)]
    for w32 in (4, 96, 2 * (16 * cv // 64 + 1)):      # truncated .. full
        got = HE.gather_pack_cuda(*args, bs, w32)
        _eq(got, HE.encode_pack_plain(*args, bs, w32))
        _eq(got, HE.encode_pack_cuda(*args, bs, w32))


@pytest.mark.parametrize("n,bs,max_len", [(1, 4096, 16), (4096 * 3, 4096, 16),
                                          (100003, 4096, 12), (999, 16, 16),
                                          (70000, 1024, 16), (70001, 1000, 16),
                                          (20001, 8192, 16),
                                          ((1 << 23) + 5, 4096, 16)])
def test_hufenc_blocks_and_stitch_match_plain(dev, n, bs, max_len):
    """The `hufenc_flat` op's one launch (`hufenc_cuda`) against its plain
    version (`hufenc_plain`: the blocks' rows and their stitch) and
    against `gather_pack_cuda` on the same codes: full blocks, a ragged
    tail, 12-bit books, 16-symbol blocks whose u32 output words gather
    bits of several blocks (a one-symbol book: 1-bit codes), blocks of
    1000 symbols, blocks wider than a 4096-symbol tile, 2^23+5 values;
    the codes also 1-3 words past a 16-byte boundary (a tile's stage
    filled partly by plain loads)."""
    rng = np.random.default_rng(n)
    for book in (Codebook.from_freqs(rng.integers(0, 1000, 1024) ** 2,
                                     max_len=max_len),
                 Codebook.from_freqs(np.eye(1024, dtype=np.int64)[7],
                                     smoothing=False)):
        codes = (rng.integers(0, 1024, n) if book.lengths[0] else
                 np.full(n, 7)).astype(np.int32)
        total = int(book.lengths.astype(np.int64)[codes].sum())
        c = torch.from_numpy(codes).to(dev)
        ln = torch.from_numpy(book.lengths.astype(np.int32)).to(dev)
        cw = torch.from_numpy(book.codes.astype(np.int32)).to(dev)
        want = HE.hufenc_plain(c, ln, cw, bs, total)
        words, nbits = HE.gather_pack_cuda(
            c[None], dispatch.all_valid(n, dev), ln[None], cw[None], bs,
            want[0].numel())
        _eq(want, (words[0], nbits[0]))
        for off in ((0, 1, 2, 3) if n < 1 << 20 else (0, 3)):
            shifted = torch.zeros(off + n, dtype=torch.int32, device=dev)
            shifted[off:] = c
            dispatch.reset_launches()
            got = HE.hufenc_cuda(shifted[off:], ln, cw, bs, total)
            assert dispatch.launches() == {"hufenc": 1}
            _eq(got, want)


@pytest.mark.parametrize("kw", [
    dict(mode="rel", eb=1e-4),
    dict(mode="rel", eb=1e-3, predictor="none", chunk_bytes=1 << 17),
    dict(mode="fixed_ratio", target_ratio=10.0, chunk_bytes=1 << 17),
    dict(mode="abs", eb=1e-3, codebook="bank", chunk_bytes=1 << 16),
], ids=["rel", "value", "fixed-ratio", "bank"])
def test_staged_round_trip_on_card_matches_cpu_and_fused(dev, kw):
    """The staged route (use_fused=False) on the card: its stream equals
    the CPU run's and the fused route's, through both pack kernels."""
    x = F.hacc_proxy(size="small")
    off = default_offline_codebook()
    staged = dict(kw, use_fused=False)
    dispatch.reset_launches()
    cg = CEAZ(CEAZConfig(device="cuda", **staged),
              offline_codebook=off).compress(x)
    launched = dispatch.launches()
    cc = CEAZ(CEAZConfig(device="cpu", **staged),
              offline_codebook=off).compress(x)
    cf = CEAZ(CEAZConfig(device="cuda", **kw),
              offline_codebook=off).compress(x)
    for other in (cc, cf):
        assert len(cg.chunks) == len(other.chunks)
        for a, b in zip(cg.chunks, other.chunks):
            for k in ("words", "block_nbits", "outlier_idx",
                      "outlier_delta"):
                assert np.array_equal(getattr(a, k), getattr(b, k)), k
            assert a.codebook_id == b.codebook_id and a.eb == b.eb
        assert np.array_equal(cg.literal_idx, other.literal_idx)
    assert launched.get("histogram", 0) > 0
    assert launched.get("gather_pack", 0) + launched.get("hufenc", 0) > 0
    y = CEAZ(CEAZConfig(device="cuda", **staged),
             offline_codebook=off).decompress(cg)
    assert y.tobytes() == CEAZ(CEAZConfig(device="cpu", **staged),
                               offline_codebook=off).decompress(cc).tobytes()


@pytest.mark.parametrize("kw", [dict(), dict(predictor="none", eb=1e-3),
                                dict(use_fused=False)])
def test_compress_batch_on_card_matches_per_shard(dev, kw):
    rng = np.random.default_rng(3)
    shards = [np.cumsum(rng.standard_normal(70000)).astype(np.float32)
              for _ in range(3)]
    comp = CEAZ(CEAZConfig(device="cuda", chunk_bytes=1 << 16, **kw),
                offline_codebook=default_offline_codebook())
    for a, b in zip(comp.compress_batch(shards),
                    [comp.compress(s) for s in shards]):
        for x, y in zip(a.chunks, b.chunks):
            assert np.array_equal(x.words, y.words)
            assert np.array_equal(x.outlier_idx, y.outlier_idx)
        assert np.array_equal(a.literal_idx, b.literal_idx)


def _gp_tables(book, C):
    """(lengths, cwords) rows of C chunks: a one-symbol book (code 512,
    one 0 bit), a two-symbol book of 1-bit codes (512 -> 1, 100 -> 0),
    or a 16-bit book (lengths 2..16 around 512)."""
    if book == "16bit":
        f = np.maximum(1, (2.0 ** np.maximum(
            0, 40 - np.abs(np.arange(1024) - 512))).astype(np.int64))
        cb = Codebook.from_freqs(f, max_len=16)
        assert cb.lengths.max() == 16
        ln, cw = cb.lengths.astype(np.int32), cb.codes.astype(np.int32)
    else:
        ln = np.zeros(1024, np.int32)
        cw = np.zeros(1024, np.int32)
        ln[512] = 1
        if book == "two_1bit":
            ln[100], cw[512] = 1, 1
    return np.stack([ln] * C), np.stack([cw] * C)


def _gp_codes(rng, book, C, cv):
    if book == "16bit":
        return np.clip(rng.normal(512, 12, (C, cv)), 0, 1023).astype(np.int32)
    if book == "two_1bit":
        return np.where(rng.random((C, cv)) < 0.5, 512, 100).astype(np.int32)
    return np.full((C, cv), 512, np.int32)


def _gp_check(dev, codes, valid, ln, cw, bs, w32s):
    """gather_pack bitwise against its plain version at each capacity,
    and the same call twice bitwise (look-back and atomics are
    order-free)."""
    args = [torch.from_numpy(a).to(dev) for a in (codes, valid, ln, cw)]
    for w32 in w32s:
        got = HE.gather_pack_cuda(*args, bs, w32)
        _eq(got, HE.encode_pack_plain(*args, bs, w32))
        _eq(got, HE.gather_pack_cuda(*args, bs, w32))


@pytest.mark.parametrize("bs", [1000, 16, 3])
@pytest.mark.parametrize("book", ["one_symbol", "two_1bit", "16bit"])
def test_gather_pack_many_tiles(dev, book, bs):
    """A row of 2^20+3 values (257 tiles, the look-back reaching back
    over many of them) beside a short row; blocks of 1000, 16 and 3
    symbols, none dividing the 4096-symbol tile (3: more blocks a tile
    than the shared sums hold, so runs add to the output directly);
    capacities that truncate in mid-tile and the full one."""
    rng = np.random.default_rng(bs)
    cv = (1 << 20) + 3
    codes = _gp_codes(rng, book, 2, cv)
    valid = rng.random((2, cv)) < 0.97
    valid[1, 5000:] = False
    ln, cw = _gp_tables(book, 2)
    full = 2 * (16 * cv // 64 + 1)
    _gp_check(dev, codes, valid, ln, cw, bs,
              (full, 128 * 37 + 50, full // 3 + 7))


def test_gather_pack_many_short_rows(dev):
    """C=70000 rows of 5 values: a grid of one tile a row, every row its
    own look-back and tickets; 16-symbol blocks; a capacity of 1 and 3
    words."""
    rng = np.random.default_rng(70000)
    C = 70000
    codes = _gp_codes(rng, "16bit", C, 5)
    valid = rng.random((C, 5)) < 0.9
    ln, cw = _gp_tables("16bit", C)
    _gp_check(dev, codes, valid, ln, cw, 16, (1, 3))


PACK_EDGES = ["clamped_codes", "invalid_rows", "ragged", "offset_views",
              "truncated", "no_rows", "no_values", "phase_b", "long_row"]


def _pack_edge(dev, case):
    """Inputs of the pass-2 pack at one of its edges -> (args, block size,
    capacities): codes outside [0, 1024); invalid positions and rows with
    none valid; cv not a multiple of 4 nor of the tile (rows off the
    16-byte grain); views whose codes and flags start off the grain;
    capacities that truncate the payload; C = 0 and cv = 0; phase B's 64
    rows of 2^17; one row of over 2^21 values."""
    shapes = {"clamped_codes": (3, 10000, 512),
              "invalid_rows": (4, 9000, 4096),
              "ragged": (5, 4099, 1000), "offset_views": (3, 8192, 4096),
              "truncated": (2, 70001, 4096), "no_rows": (0, 100, 4096),
              "no_values": (3, 0, 4096), "phase_b": (64, 1 << 17, 4096),
              "long_row": (1, (1 << 21) + 5, 4096)}
    C, cv, bs = shapes[case]
    rng = np.random.default_rng(len(case))
    _, ln, cw = _books(rng, max(C, 1))
    ln, cw = ln[:C], cw[:C]
    codes = np.clip(rng.normal(512, 40, (C, cv)), 0, 1023).astype(np.int32)
    valid = rng.random((C, cv)) < 0.97
    if case == "clamped_codes":
        codes = rng.integers(-3000, 4000, (C, cv)).astype(np.int32)
        codes[:, :4] = [np.iinfo(np.int32).min, -1, 1024,
                        np.iinfo(np.int32).max]
    if case == "invalid_rows":
        valid[1] = False
        valid[3] = False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    args = [t(codes), t(valid), t(ln), t(cw)]
    if case == "offset_views":
        c, v = args[:2]
        args[0] = torch.cat([c.reshape(-1)[:1], c.reshape(-1)])[1:] \
            .reshape(C, cv)
        args[1] = torch.cat([v.reshape(-1)[:3], v.reshape(-1)])[3:] \
            .reshape(C, cv)
        assert args[0].data_ptr() % 16 == 4 and args[1].data_ptr() % 16 == 3
    full = 2 * (16 * cv // 64 + 1)
    w32s = (1, 5, 1000, full // 3) if case == "truncated" else (full,)
    return args, bs, w32s


@pytest.mark.parametrize("case", PACK_EDGES)
def test_pack_kernel_edges(dev, case):
    """The one-launch pack under both ops (`hufenc`, the fused route's pass
    2, and `gather_pack`) at each edge of _pack_edge, bitwise against
    encode_pack_plain, each call twice (look-back and atomics are
    order-free)."""
    args, bs, w32s = _pack_edge(dev, case)
    for w32 in w32s:
        want = HE.encode_pack_plain(*args, bs, w32)
        for pack in (HE.encode_pack_cuda, HE.gather_pack_cuda):
            got = pack(*args, bs, w32)
            _eq(got, want)
            _eq(got, pack(*args, bs, w32))


def test_ceaz_chunk_op_at_phase_c_shape(dev):
    """The bank encode op, whose pack is the pass-2 pack, at phase C's
    shape: 64 rows of 2^17 values, 4096-value blocks, provisioned at 8
    bits a value."""
    C, cv = 64, 1 << 17
    work2, prev2, valid2, ebs = _bank_rows(dev, C, cv, C * cv, 7)
    ln, cw = _bank_tables(dev)
    args = (work2, prev2, valid2, ebs, ln, cw, 4096,
            2 * ((cv * 8 + 63) // 64 + 1), "lorenzo")
    _eq(MK.ceaz_chunk_cuda(*args), MK.ceaz_chunk_plain(*args))


@pytest.mark.parametrize("C,n,case", [
    (1, (1 << 22) + 5, "one_code"), (5, 4099, "odd_rows"),
    (4, 10000, "invalid_rows"), (3, 9001, "offset_views")])
def test_histogram_kernel_regimes(dev, C, n, case):
    """One long row of a single code (each thread's run never breaks),
    odd n with several rows (rows start off the 16-byte grain), rows
    that are all invalid, and views whose flags are not 4-byte aligned
    (the scalar path); the same call twice bitwise."""
    rng = np.random.default_rng(n)
    codes = np.clip(rng.normal(512, 3, (C, n)), -2, 1030).astype(np.int32)
    valid = rng.random((C, n)) < 0.9
    if case == "one_code":
        codes[:] = 512
        valid[:] = True
    if case == "invalid_rows":
        valid[1::2] = False
    c, v = torch.from_numpy(codes).to(dev), torch.from_numpy(valid).to(dev)
    if case == "offset_views":
        c = torch.cat([c.reshape(-1)[:3], c.reshape(-1)])[3:].reshape(C, n)
        v = torch.cat([v.reshape(-1)[:1], v.reshape(-1)])[1:].reshape(C, n)
        assert v.data_ptr() % 4 == 1
    got = HG.histogram_cuda(c, v)
    _eq(got, HG.histogram_plain(c, v))
    _eq(got, HG.histogram_cuda(c, v))
    if case == "one_code":
        assert int(got[0, 512]) == n and int(got.sum()) == n
    if case == "invalid_rows":
        assert int(got[1::2].sum()) == 0


# ---------------------------------------------------------------------------
# The warp walks (csrc/warp_walk.cuh): hufdec_tiles and the decode
# megakernel, each call twice and bitwise against the plain version
# ---------------------------------------------------------------------------

def _fused_plain(args, bs):
    """The decode megakernel's function at any shape: the walk with one
    window a row, then the plain patch and inverse (what
    ceaz_chunk_dec_plain computes up to 2^17 values a row)."""
    words2, nbits2 = args[:2]
    codes = HD.walk_plain(*args[:6], bs, nbits2.shape[1], words2.shape[1])
    return MK.patch_and_inverse(codes, args[2], *args[6:])


def _dec_meta_rows(dev, rng, C, Ko):
    """Lorenzo rows chained in segments of up to 3 rows; every fourth row
    a value row (its own segment) with a base."""
    seg0 = np.arange(C, dtype=np.int32)
    islor = np.ones(C, np.int32)
    base = np.zeros(C, np.int32)
    head = 0
    for c in range(C):
        if c % 4 == 3:
            islor[c], base[c], head = 0, rng.integers(-600, 600), c + 1
            continue
        head = c if c - head >= 3 else head
        seg0[c] = head
    odelta2 = rng.integers(-2**31, 2**31, (C, Ko)).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (odelta2, base, seg0, islor)]


def _walks_twice(walk, bs, meta=None):
    """hufdec_tiles, hufdec (the split route's walk) and, given the decode
    metadata, the decode megakernel on `walk`, each twice, bitwise against
    the plain version: once with the tables checked on the card, once with
    copies marked as checked on the host (no wait) -> their counters."""
    marked = list(walk)
    marked[3], marked[4] = walk[3].clone(), walk[4].clone()
    HD.mark_ranges_checked(marked[3], marked[4])
    HD.reset_walk_stats()
    stats = {}
    for name, cuda, plain in (
            ("hufdec_tiles", HD.hufdec_tiles_cuda, HD.hufdec_tiles_plain),
            ("hufdec", HD.hufdec_cuda, HD.hufdec_plain)):
        want = plain(*walk, bs)
        for w in (walk, marked):
            _eq(cuda(*w, bs), want)
        stats[name] = HD.walk_stats(name)
    if meta is not None:
        want = _fused_plain(walk + meta, bs)
        for w in (walk, marked):
            _eq(MK.ceaz_chunk_dec_fused_cuda(*w, *meta, bs), want)
        stats["ceaz_chunk_dec_fused"] = HD.walk_stats("ceaz_chunk_dec_fused")
    return stats


@pytest.mark.parametrize("counts,bs", [
    ([1800 * 3600], 4096),               # phase A: one 6.48 M-value row
    ([1 << 17] * 64, 4096),              # phase B: 64 rows of 2^17
    ([100000, 65536, 3], 256),           # bs 256, tail blocks
    ([70000, 123457, 1], 1000)])         # bs not a power of two
def test_warp_walks_on_valid_streams(dev, counts, bs):
    """Valid streams, each row its own book: every block with symbols
    takes the fast path (no exact block), tail blocks and rows past
    their count included."""
    walk = _valid_walk_args(dev, counts, bs, len(counts))
    meta = _dec_meta_rows(dev, np.random.default_rng(1), len(counts), 64)
    for name, s in _walks_twice(walk, bs, meta).items():
        assert s["exact_blocks"] == 0 and s["fast_blocks"] > 0, (name, s)


def test_warp_walks_mix_valid_and_corrupted_rows(dev):
    """One launch of five rows: valid rows beside a row with flipped
    payload bits, one with garbage bit counts and one whose count runs
    past its bits; only the corrupted rows' blocks take walk_lane."""
    walk = _valid_walk_args(dev, [20000, 20000, 20000, 9000, 20000], 512, 4)
    w, nb, counts = (t.clone() for t in walk[:3])
    w[1, 100:400:37] ^= 0x10204081
    nb[2] = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1 << 13, nb.shape[1]).astype(np.int32))
    counts[3] = 20000
    walk = [w, nb, counts] + walk[3:]
    meta = _dec_meta_rows(dev, np.random.default_rng(2), 5, 16)
    for name, s in _walks_twice(walk, 512, meta).items():
        assert s["exact_blocks"] > 0 and s["fast_blocks"] > 0, (name, s)


def _book_walk_args(dev, book, counts, bs, seed):
    """Rows under one shared hard book: 16-bit codes, one symbol (a one-bit
    code; windows starting with a 1 have length 0) or 1024 codes of 10
    bits (segment guesses never resynchronise)."""
    from repro_torch.core.huffman import _canonize, encode
    from repro_torch.runtime.fused_decode import _u64_to_u32
    rng = np.random.default_rng(seed)
    if book == "16bit":
        f = np.maximum(1, (2.0 ** np.maximum(
            0, 40 - np.abs(np.arange(1024) - 512))).astype(np.int64))
        cb = Codebook.from_freqs(f, max_len=16)
        assert cb.lengths.max() == 16
        draw = lambda n: np.clip(rng.normal(512, 12, n), 0, 1023)
    elif book == "one_symbol":
        ln = np.zeros(1024, np.uint8)
        ln[512] = 1
        cb = Codebook(lengths=ln, codes=_canonize(ln.astype(np.int64)))
        draw = lambda n: np.full(n, 512)
    else:
        cb = Codebook.from_freqs(np.ones(1024, np.int64))
        assert set(cb.lengths.tolist()) == {10}
        draw = lambda n: rng.integers(0, 1024, n)
    rows = [encode(draw(n).astype(np.int64), cb, bs) for n in counts]
    C = len(counts)
    words2 = np.zeros((C, max(2 * len(r[0]) for r in rows) + 2), np.uint32)
    nbits2 = np.zeros((C, max(len(r[1]) for r in rows)), np.int32)
    for i, (w64, bnb, _) in enumerate(rows):
        w = _u64_to_u32(w64)
        words2[i, :len(w)] = w
        nbits2[i, :len(bnb)] = bnb
    sym, ln = cb.tables()
    arrays = (words2.view(np.int32), nbits2, np.asarray(counts, np.int32),
              sym.astype(np.int32), ln.astype(np.int32), np.zeros(C, np.int32))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("bs", [4096, 500])
@pytest.mark.parametrize("book", ["16bit", "one_symbol", "equal_length"])
def test_warp_walks_on_hard_books(dev, book, bs):
    """16-bit codes, a one-symbol book and equal-length codes (up to 31
    sync rounds): every block kept from the fast path, bitwise."""
    walk = _book_walk_args(dev, book, [3 * bs + 17, 2 * bs, 5], bs, 5)
    meta = _dec_meta_rows(dev, np.random.default_rng(6), 3, 8)
    for name, s in _walks_twice(walk, bs, meta).items():
        assert s["exact_blocks"] == 0, (name, s)
        if book == "equal_length" and bs == 500:
            assert s["max_sync_rounds"] >= 8, (name, s)


def test_warp_walks_over_65535_rows(dev):
    """C = 70000 rows (more than a grid's y dimension holds): identical
    valid rows of 300 values in 256-value blocks, chained segments."""
    one = _valid_walk_args(dev, [300], 256, 9)
    C = 70000
    walk = [t.expand(C, *t.shape[1:]).contiguous() if t.ndim == 2
            else t.expand(C).contiguous() for t in one[:3]]
    walk += [one[3], one[4], torch.zeros(C, dtype=torch.int32, device=dev)]
    meta = _dec_meta_rows(dev, np.random.default_rng(10), C, 2)
    for name, s in _walks_twice(walk, 256, meta).items():
        assert s["exact_blocks"] == 0 and s["fast_blocks"] == 2 * 2 * C, \
            (name, s)


def test_warp_walks_on_the_fuzz_corpus(dev):
    """The decode fuzz corpus: its garbage cases (random words, tables
    with length-0 entries, random bit counts; the fused regime and one
    word-tiled row) and its bitflips on a valid three-row stream: both
    kernels agree with their plain versions, and corrupted blocks take
    walk_lane."""
    import json
    import os
    corpus = json.load(open(os.path.join(os.path.dirname(__file__), "corpus",
                                         "decode_fuzz_corpus.json")))
    g = corpus["garbage"]
    rng = np.random.default_rng(g["seed"])
    shapes = [(int(rng.integers(1, 4)), int(rng.integers(1, 7)), 32)
              for _ in range(g["cases"])] + [(1, (1 << 17) // 256 + 8, 256)]
    exact = 0
    for C, NB, bs in shapes:
        W = int(rng.integers(3, 24))
        arrays = [rng.integers(0, 1 << 32, size=(C, W), dtype=np.uint32)
                  .view(np.int32),
                  rng.integers(0, 1 << 12, size=(C, NB)).astype(np.int32),
                  rng.integers(0, NB * bs + 1, size=C).astype(np.int32),
                  rng.integers(0, 1024, size=1 << 16).astype(np.int32),
                  rng.integers(0, 17, size=1 << 16).astype(np.int32),
                  np.zeros(C, np.int32)]
        walk = [torch.from_numpy(a).to(dev) for a in arrays]
        meta = _dec_meta_rows(dev, rng, C, 4)
        s = _walks_twice(walk, bs, meta)
        exact += sum(v["exact_blocks"] for v in s.values())
    assert exact > 0
    walk = _valid_walk_args(dev, [4096, 3000, 1500], 512, 3)
    meta = _dec_meta_rows(dev, np.random.default_rng(4), 3, 32)
    cases = [c for c in corpus["cases"] if c["kind"] == "bitflip"]
    r = np.random.default_rng(corpus["random"]["seed"])
    cases += [{"record": int(r.integers(3)), "rel_off": int(r.integers(1 << 16)),
               "bit": int(r.integers(8))}
              for _ in range(corpus["random"]["n_bitflips"])]
    exact = 0
    for case in cases:
        words = walk[0].cpu().numpy().copy()
        row = case["record"] % words.shape[0]
        payload = words[row].view(np.uint8)
        payload[case["rel_off"] % payload.size] ^= 1 << (case["bit"] & 7)
        s = _walks_twice([torch.from_numpy(words).to(dev)] + walk[1:], 512,
                         meta)
        exact += sum(v["exact_blocks"] for v in s.values())
    assert exact > 0


@pytest.mark.parametrize("bad", [("sym", 1024), ("sym", -1), ("len", 17)])
def test_warp_walks_raise_on_tables_out_of_range(dev, bad):
    """A decode table entry with a symbol outside [0, 1024) or a length
    over 16 does not fit the 16-bit shared-memory entry: the three
    wrappers raise, also on tables marked as checked on the host and changed in
    place since."""
    walk = _valid_walk_args(dev, [5000], 512, 11)
    which, v = bad
    k = 3 if which == "sym" else 4
    t = walk[k].clone()
    HD.mark_ranges_checked(t)
    t[12345] = v
    walk[k] = t
    meta = _dec_meta_rows(dev, np.random.default_rng(12), 1, 4)
    with pytest.raises(ValueError):
        HD.hufdec_tiles_cuda(*walk, 512)
    with pytest.raises(ValueError):
        HD.hufdec_cuda(*walk, 512)
    with pytest.raises(ValueError):
        MK.ceaz_chunk_dec_fused_cuda(*walk, *meta, 512)


# -- the .ceazs stream engine and the file write on the card ------------------

def _stream_rows(path):
    from repro_torch.io import engine as E
    with E.StreamReader(path) as r:
        return r.records, [r.payload(i) for i in range(len(r))]


@pytest.mark.parametrize("route", ["fused", "staged", "bank"])
def test_stream_round_trip_on_card(dev, tmp_path, route):
    """chip_smoke.py's W phases at a small size: the dump written on the
    card (the compress stage on the engine's thread) holds the CPU run's
    payloads bit for bit, overlap=False writes the same records, the
    default reader (on the card) decodes to the CPU run's bytes, and the
    kernels of the route launched from the compress thread."""
    from repro_torch.io import engine as E
    from repro_torch.io import filewrite as FW
    kw = {"fused": {}, "staged": dict(use_fused=False),
          "bank": dict(codebook="bank")}[route]
    shards = ([F.nyx_proxy(seed=5 + r) for r in range(3)] if route == "fused"
              else list(F.hacc_proxy().reshape(4, -1)))
    card = CEAZ(CEAZConfig(device="cuda", **kw))
    cpu = CEAZ(CEAZConfig(device="cpu", **kw))
    dispatch.reset_launches()
    st = FW.parallel_compressed_write(str(tmp_path / "a"), shards, comp=card,
                                      fsync=False)
    counts = dispatch.launches()
    assert counts.get("gather_pack_tiled", 0) + counts.get("hufenc", 0) \
        + counts.get("gather_pack", 0) > 0, counts
    FW.parallel_compressed_write(str(tmp_path / "b"), shards, comp=card,
                                 overlap=False, fsync=False)
    recs, pays = _stream_rows(str(tmp_path / "a" / FW.DUMP_NAME))
    assert _stream_rows(str(tmp_path / "b" / FW.DUMP_NAME)) == (recs, pays)
    cs = [cpu.compress(x) for x in shards]
    assert pays == [E.serialize_payload(c)[0] for c in cs]
    dispatch.reset_launches()
    back = FW.parallel_read(str(tmp_path / "a"))
    assert sum(dispatch.launches().values()) > 0
    for b, c, x in zip(back, cs, shards):
        assert b.tobytes() == cpu.decompress(c).tobytes()
        assert np.abs(b.astype(np.float64) - x).max() \
            <= 1e-4 * (float(x.max()) - float(x.min()))
    assert st["ratio"] > 1 and st["raw_bytes"] == sum(x.nbytes
                                                      for x in shards)
    files = []
    for sync in (True, False):
        path = str(tmp_path / f"t{sync}.ceazs")
        E.write_stream(path, shards, card, sync=sync, telemetry=False,
                       fsync=False)
        files.append(open(path, "rb").read())
    assert files[0] == files[1]


def test_stream_defaults_run_on_card(dev, tmp_path):
    """The entry points' default facades run on the card."""
    from repro_torch.io import engine as E
    shards = [F.nyx_proxy(seed=1)]
    path = str(tmp_path / "d.ceazs")
    dispatch.reset_launches()
    E.write_stream(path, shards, fsync=False)
    assert dispatch.launches().get("gather_pack_tiled", 0) > 0
    with E.AsyncDecodeReadEngine(path) as eng:
        assert eng._comp.device.type == "cuda"
        (out,) = [o for _, o in eng]
    assert out.shape == shards[0].shape


def test_gather_on_card_matches_cpu(dev, tmp_path):
    """chip_smoke.py's phase R at a small size: the gather's payloads on
    the card equal the CPU run's and the card's single compress, its
    decode the CPU's bytes; the gather stream written and read on the
    card holds the same payloads."""
    from repro_torch.io import collectives as COL
    from repro_torch.io import engine as E
    ranks = [F.nyx_proxy(seed=5 + r) for r in range(3)]
    kw = dict(chunk_values=1 << 16, block_size=1024)
    dispatch.reset_launches()
    comps, stats = COL.ceaz_gather(ranks, **kw)
    assert dispatch.launches().get("gather_pack_tiled", 0) > 0
    cpu, cpu_stats = COL.ceaz_gather(ranks, device="cpu", **kw)
    assert stats == cpu_stats
    one = CEAZ(CEAZConfig(mode="rel", eb=1e-4, chunk_bytes=4 << 16,
                          block_size=1024, device="cuda"))
    for x, c, cc in zip(ranks, comps, cpu):
        pay = E.serialize_payload(c)[0]
        assert pay == E.serialize_payload(cc)[0]
        assert pay == E.serialize_payload(one.compress(x))[0]
    back = COL.ceaz_gather_decode(comps, block_size=1024)
    back_c = COL.ceaz_gather_decode(cpu, block_size=1024, device="cpu")
    for b, bc in zip(back, back_c):
        assert b.tobytes() == bc.tobytes()
    path = str(tmp_path / "g.ceazs")
    COL.ceaz_gather_stream(ranks, path, **kw)
    _, pays = _stream_rows(path)
    assert pays == [E.serialize_payload(c)[0] for c in cpu]
    arrays, _ = COL.read_gather_stream(path)
    for a, b in zip(arrays, back_c):
        assert a.tobytes() == b.tobytes()


def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """chip_smoke.py's phase K at a small size: a checkpoint of card
    tensors holds the CPU save's records, restores within the bound on
    the host (plan=None) and onto a one-device mesh on cuda:0 through a
    bf16 leaf_transform, and its stream pages through PagedParamStore on
    the card to the same bf16 bits."""
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.sharding import make_plan
    from repro_torch.serve import PagedParamStore
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {"layers": [{"mlp": {"wi": torch.randn(64, 256, generator=gen,
                                                   device="cuda")},
                         "norm": torch.ones(64, device="cuda")}],
             "step": torch.tensor(3, device="cuda")}
    C.save_checkpoint(str(tmp_path / "g"), state, 1)
    C.save_checkpoint(str(tmp_path / "c"), state, 1, device="cpu")
    stream = lambda d: str(tmp_path / d / "step_00000001" / C.LEAVES_STREAM)
    assert _stream_rows(stream("g")) == _stream_rows(stream("c"))
    host, meta = C.restore_checkpoint(str(tmp_path / "g"))
    assert meta == {"step": 1}
    w = state["layers"][0]["mlp"]["wi"].cpu().numpy()
    got = host["layers"][0]["mlp"]["wi"]
    assert isinstance(got, np.ndarray)
    assert np.abs(got - w).max() <= 5e-4 * float(w.max() - w.min())
    plan = make_plan(make_mesh((1, 1), ("data", "model")))
    cast = lambda k, a: torch.from_numpy(np.asarray(a)).to(torch.bfloat16) \
        if np.asarray(a).dtype.kind == "f" else torch.from_numpy(
            np.asarray(a))
    placed, _ = C.restore_checkpoint(str(tmp_path / "g"), plan=plan,
                                     leaf_transform=cast)
    t = placed["layers"][0]["mlp"]["wi"]
    assert t.device == torch.device("cuda", 0) and t.dtype == torch.bfloat16
    assert torch.equal(t.cpu(), torch.from_numpy(got).to(torch.bfloat16))
    with PagedParamStore(stream("g")) as store, store.pin() as pin:
        leaf = pin.get("layers/0/mlp/wi")
    assert leaf.is_cuda and torch.equal(leaf.cpu(), t.cpu())


def test_reduced_gemma3_serving_on_card_matches_cpu(dev, tmp_path):
    """chip_smoke.py's phase SERVE at the reduced gemma3-1b: a checkpoint
    saved on the card, restored for serving (bf16) in full and paged,
    then prefill and 24 decode steps (past the 16-slot rings) on the card
    against the same restored weights through the port on the CPU, within
    the CPU parity tests' bound (rtol 0.06, atol 0.05)."""
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.configs import get_arch
    from repro_torch.convert import tree_items
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import ShardingPlan
    cfg, plan = get_arch("gemma3-1b").reduced(), ShardingPlan(mesh=None)
    C.save_checkpoint(str(tmp_path), T.init_params(0, cfg), 1)
    params, meta = S.restore_serving_params(str(tmp_path), plan)
    assert meta == {"step": 1}
    flat = dict(tree_items(params))
    assert all(v.is_cuda and v.dtype == torch.bfloat16
               for v in flat.values())
    store, _ = S.restore_serving_params(str(tmp_path), plan, paged=True)
    with store, store.pin() as pin:
        for k, v in tree_items(pin.params()):
            assert torch.equal(v.view(torch.int16), flat[k].view(torch.int16))
    cpu = {k: v.cpu() for k, v in flat.items()}
    cpu = C._unflatten_like(cpu, None)
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    close = lambda a, b: np.testing.assert_allclose(
        a.float().cpu().numpy(), b.float().numpy(), rtol=0.06, atol=0.05)
    pre = S.make_prefill_fn(cfg, plan, 2, 24)[0]
    close(pre(params, toks.cuda()), pre(cpu, toks))
    dec = S.make_decode_fn(cfg, plan, 2, 32)[0]
    gc, cc = T.init_cache(cfg, 2, 32), T.init_cache(cfg, 2, 32, device="cpu")
    for t in range(24):
        lg, gc = dec(params, toks[:, t].cuda(), gc)
        lc, cc = dec(cpu, toks[:, t], cc)
        close(lg, lc)
    assert gc["pos"].tolist() == [24, 24]


def _route_gates(T, E, case, seed):
    g = torch.Generator().manual_seed(seed)
    if case == "ties":                 # few distinct logits: exact ties
        logits = torch.randint(0, 3, (T, E), generator=g).float()
    else:                              # two experts overfull: drops
        logits = torch.randn((T, E), generator=g)
        logits[:, :2] += 6.0
    return torch.softmax(logits, -1)


@pytest.mark.parametrize("case", ["ties", "overfull"])
def test_moe_routing_and_combine_on_card_match_cpu(dev, case):
    """At deepseek-v2's expert count (160, top 6) over 512 tokens: the
    card's top-k ids and weights, sorted order, counts, slots and drop
    mask equal the plain CPU routing's bitwise given the same gates, and
    the combine's fixed-order f32 sums equal the CPU's (no atomics)."""
    from repro_torch.models import modules as M
    T, E, k = 512, 160, 6
    gates = _route_gates(T, E, case, 3)
    cap = M._moe_capacity(T, M.MoEConfig(d_model=8, d_ff=8, n_experts=E,
                                         top_k=k), E)
    cpu = M.moe_route(gates, k, 0, E, cap)
    card = M.moe_route(gates.to(dev), k, 0, E, cap)
    for name, v in cpu.items():
        _eq(card[name], v)
    if case == "overfull":
        assert not bool(cpu["valid"].all())
    yp = torch.randn((T * k, 64), generator=torch.Generator().manual_seed(4))
    yp = yp * 10.0 ** torch.randint(-4, 4, (T * k, 1),
                                    generator=torch.Generator().manual_seed(5))
    want = M._combine(yp, cpu["order"], T, k)
    for _ in range(3):                   # the same bits on every run
        _eq(M._combine(yp.to(dev), card["order"], T, k), want)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "phi3.5-moe-42b-a6.6b"])
def test_reduced_moe_serving_on_card_matches_cpu(dev, arch):
    """The reduced MoE archs on the card against the port on the CPU, the
    compute dtype f32 on both (a bf16 router's near-ties flip between
    any two executions): prefill, and 12 decode steps through the MLA
    latent or KV cache, within the bound (rtol 0.06, atol 0.05); the
    cache slots the same within it."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import map_tree, tree_items
    from repro_torch.models import modules as M
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import ShardingPlan
    cfg, plan = get_arch(arch).reduced(), ShardingPlan(mesh=None)
    cpu = T.init_params(0, cfg, device="cpu")
    card = map_tree(lambda _k, v: v.to(dev), cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    close = lambda a, b: np.testing.assert_allclose(
        a.float().cpu().numpy(), b.float().numpy(), rtol=0.06, atol=0.05)
    old, M.COMPUTE_DTYPE = M.COMPUTE_DTYPE, torch.float32
    try:
        close(T.serve_prefill(card, cfg, toks.to(dev), plan),
              T.serve_prefill(cpu, cfg, toks, plan))
        gc = T.init_cache(cfg, 2, 16, torch.float32, device=dev)
        cc = T.init_cache(cfg, 2, 16, torch.float32, device="cpu")
        for t in range(12):
            lg, gc = T.serve_decode(card, cfg, toks[:, t].to(dev), gc, plan)
            lc, cc = T.serve_decode(cpu, cfg, toks[:, t], cc, plan)
            close(lg, lc)
    finally:
        M.COMPUTE_DTYPE = old
    want = dict(tree_items(cc))
    for k, v in tree_items(gc):
        close(v, want[k])
    assert gc["pos"].tolist() == [12, 12]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_reduced_ssm_serving_on_card_matches_cpu(dev, arch):
    """The reduced SSM archs on the card against the port on the CPU,
    the compute dtype f32 on both: prefill of 32 tokens (rwkv6's chunked
    WKV needs a multiple of 16; zamba2's one chunk of 64 pads its tail),
    then 32 teacher-forced decode steps and the final
    caches (conv, state, sx, sx_cmix, the shared block's k and v) within
    the bound (rtol 0.06, atol 0.05)."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import map_tree, tree_items
    from repro_torch.models import modules as M
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sharding import ShardingPlan
    cfg, plan = get_arch(arch).reduced(), ShardingPlan(mesh=None)
    cpu = T.init_params(0, cfg, device="cpu")
    card = map_tree(lambda _k, v: v.to(dev), cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    close = lambda a, b: np.testing.assert_allclose(
        a.float().cpu().numpy(), b.float().numpy(), rtol=0.06, atol=0.05)
    old, M.COMPUTE_DTYPE = M.COMPUTE_DTYPE, torch.float32
    try:
        close(T.serve_prefill(card, cfg, toks.to(dev), plan),
              T.serve_prefill(cpu, cfg, toks, plan))
        gc = T.init_cache(cfg, 2, 32, torch.float32, device=dev)
        cc = T.init_cache(cfg, 2, 32, torch.float32, device="cpu")
        for t in range(32):
            lg, gc = T.serve_decode(card, cfg, toks[:, t].to(dev), gc, plan)
            lc, cc = T.serve_decode(cpu, cfg, toks[:, t], cc, plan)
            close(lg, lc)
    finally:
        M.COMPUTE_DTYPE = old
    want = dict(tree_items(cc))
    for k, v in tree_items(gc):
        close(v, want[k])
    assert gc["pos"].tolist() == [32, 32]


def _rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


@pytest.mark.parametrize("window", [None, 40])
def test_flash_backward_on_card_matches_cpu(dev, window):
    """The flash backward (several q and kv blocks, MQA, bf16) on the card
    against the port on the CPU: dq, dk, dv within one bf16 rounding in
    relative L2 (the f32 sums' order differs, so a bf16 rounding of p or
    ds can flip)."""
    from repro_torch.models import modules as M
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(s, generator=g).to(torch.bfloat16)
                   for s in ((2, 300, 4, 32), (2, 300, 1, 32),
                             (2, 300, 1, 32), (2, 300, 4, 32)))

    def grads(device):
        t = [x.to(device).requires_grad_(True) for x in (q, k, v)]
        out = M.flash_attention(*t, causal=True, window=window, bq=64,
                                bk=128)
        return torch.autograd.grad(out, t, do.to(device))
    for a, b in zip(grads(dev), grads("cpu")):
        assert a.is_cuda and a.dtype == b.dtype == torch.bfloat16
        assert _rel_l2(a, b) <= 2.0 ** -7


def test_reduced_train_step_on_card_matches_cpu(dev):
    """One train step of the reduced gemma3-1b on the card against the CPU,
    the compute dtype f32 on both sides: loss rtol 1e-5, the grad norm and
    every leaf's first moment (0.1 of its clipped gradient, in bf16)
    within 2^-7."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import map_tree, tree_items
    from repro_torch.data.synthetic import DataConfig, batch_for_step
    from repro_torch.launch import train as TR
    from repro_torch.models import modules as M
    from repro_torch.runtime.sharding import ShardingPlan
    cfg, plan = get_arch("gemma3-1b").reduced(), ShardingPlan(mesh=None)
    tc = TR.TrainConfig()
    state = TR.init_state(0, cfg, tc, plan, device="cpu")
    batch = batch_for_step(DataConfig(vocab_size=cfg.vocab_size,
                                      global_batch=2, seq_len=48), 0)
    old, M.COMPUTE_DTYPE = M.COMPUTE_DTYPE, torch.float32
    try:
        out = {d: TR.make_train_step(cfg, tc, plan, device=d)(
            map_tree(lambda _p, x: x.to(d), state), TR.batch_on(batch, d))
            for d in (dev, "cpu")}
    finally:
        M.COMPUTE_DTYPE = old
    (gs, gm), (cs, cm) = out[dev], out["cpu"]
    np.testing.assert_allclose(float(gm["loss"]), float(cm["loss"]),
                               rtol=1e-5)
    assert abs(float(gm["grad_norm"]) / float(cm["grad_norm"]) - 1) \
        <= 2.0 ** -7
    assert all(v.is_cuda for _, v in tree_items(gs["params"]))
    mu = dict(tree_items(cs["opt"]["mu"]))
    for k, v in tree_items(gs["opt"]["mu"]):
        assert v.is_cuda and _rel_l2(v, mu[k]) <= 2.0 ** -7, k


def test_training_checkpoint_on_card_restores_on_cpu(dev, tmp_path):
    """A training state saved on the card (f32 params, bf16 moments, the
    step) restores on the CPU to the card's own restore, bit for bit."""
    from repro_torch.checkpoint import ckpt as C
    from repro_torch.configs import get_arch
    from repro_torch.convert import tree_items
    from repro_torch.launch import train as TR
    from repro_torch.runtime.sharding import ShardingPlan
    cfg, plan = get_arch("gemma3-1b").reduced(), ShardingPlan(mesh=None)
    state = TR.init_state(0, cfg, TR.TrainConfig(), plan, device=dev)
    C.save_checkpoint(str(tmp_path), state, 1, extra={"data": {"step": 1}})
    card, meta = C.restore_checkpoint(str(tmp_path))
    cpu, meta2 = C.restore_checkpoint(str(tmp_path), device="cpu")
    assert meta == meta2 == {"step": 1, "data": {"step": 1}}
    cpu = dict(tree_items(cpu))
    for k, v in tree_items(card):
        w = cpu[k]
        a = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
        b = w if isinstance(w, torch.Tensor) else torch.from_numpy(w)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), k
    restored, _ = TR.restore_state(str(tmp_path), plan, dev)
    assert all(v.is_cuda for _, v in tree_items(restored))
