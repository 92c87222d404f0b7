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
