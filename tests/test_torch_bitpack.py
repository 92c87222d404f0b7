"""The port's bitpack ops (src/repro_torch/kernels/bitpack/ops.py) against
the JAX reference, on the CPU: the tile layout against the Pallas kernel
in interpret mode and its jnp oracle (``bitpack/ref.py``), the
consecutive layout against ``grad_compress.py::pack_jnp``/``unpack_jnp``,
the b-bit mask, and the dispatch registry. Inputs are numpy-seeded;
every comparison is bitwise (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitpack import kernel as RBK
from repro.kernels.bitpack import ops as RBO
from repro.kernels.bitpack import ref as RBR
from repro.optim.grad_compress import pack_jnp, unpack_jnp
from repro_torch.kernels import dispatch
from repro_torch.kernels.bitpack import ops as BP

BITS = [2, 4, 8, 16]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", [7, 4096, 50000])
def test_tile_layout_matches_pallas_and_ref(bits, n):
    v = np.random.default_rng(n + bits).integers(
        0, 1 << bits, n).astype(np.int32)
    words = BP.pack_flat(torch.from_numpy(v), bits)
    assert words.dtype == torch.int32
    assert words.shape == (RBO.packed_rows(n, bits), RBK.LANES)
    want = np.asarray(RBO.pack_flat(jnp.asarray(v), bits, interpret=True))
    np.testing.assert_array_equal(_u32(words), want)
    rows = BP.packed_rows(n, bits)
    vals = np.zeros(rows * (32 // bits) * BP.LANES, np.int32)
    vals[:n] = v
    tile = vals.reshape(rows, 32 // bits, BP.LANES)
    np.testing.assert_array_equal(
        _u32(BP.pack(torch.from_numpy(tile), bits)),
        np.asarray(RBR.pack(jnp.asarray(tile), bits)))
    back = BP.unpack_flat(words, n, bits)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(RBO.unpack_flat(jnp.asarray(want), n, bits,
                                                 interpret=True)))
    np.testing.assert_array_equal(back.numpy(), v)
    np.testing.assert_array_equal(
        BP.unpack(words, bits).numpy(),
        np.asarray(RBR.unpack(jnp.asarray(want), bits)))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n", [1, 7, 4097, 50001])
def test_word_layout_matches_pack_jnp(bits, n):
    v = np.random.default_rng(n * bits).integers(
        0, 1 << bits, n).astype(np.int32)
    words = BP.pack_words(torch.from_numpy(v), bits)
    want = np.asarray(pack_jnp(jnp.asarray(v), bits))
    assert words.shape == (BP.words_len(n, bits),) == want.shape
    np.testing.assert_array_equal(_u32(words), want)
    back = BP.unpack_words(words, n, bits)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(unpack_jnp(jnp.asarray(want), n, bits)))
    np.testing.assert_array_equal(back.numpy(), v)


def _np_pack_words(v: np.ndarray, bits: int) -> np.ndarray:
    """Masked MSB-first pack in numpy uint64, one value at a time."""
    per = 32 // bits
    out = np.zeros(-(-v.size // per), np.uint64)
    for i, x in enumerate(v.astype(np.int64)):
        out[i // per] |= np.uint64((int(x) & ((1 << bits) - 1))
                                   << (32 - bits * (i % per + 1)))
    return out.astype(np.uint32)


@pytest.mark.parametrize("bits", BITS)
def test_out_of_range_values_are_masked(bits):
    """Values outside [0, 2^b) keep their low b bits in both layouts, as
    the Pallas kernel masks them (kernel.py:28)."""
    i32 = np.iinfo(np.int32)
    v = np.random.default_rng(bits).integers(i32.min, i32.max, 3001,
                                             dtype=np.int64).astype(np.int32)
    v[:4] = (i32.min, i32.max, -1, 1 << bits)
    words = BP.pack_flat(torch.from_numpy(v), bits)
    np.testing.assert_array_equal(
        _u32(words),
        np.asarray(RBO.pack_flat(jnp.asarray(v), bits, interpret=True)))
    masked = v & ((1 << bits) - 1)
    np.testing.assert_array_equal(
        BP.unpack_flat(words, v.size, bits).numpy(), masked)
    w2 = BP.pack_words(torch.from_numpy(v), bits)
    np.testing.assert_array_equal(_u32(w2), _np_pack_words(v, bits))
    np.testing.assert_array_equal(
        BP.unpack_words(w2, v.size, bits).numpy(), masked)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 8 * 1024 * 4 + 1])
def test_layout_sizes_match_reference(n):
    for bits in BITS:
        assert BP.packed_rows(n, bits) == RBO.packed_rows(n, bits)
        assert BP._layout(n, bits) == RBO._layout(n, bits)
        assert BP.words_len(n, bits) == -(-n * bits // 32)


def test_dispatch_resolution_and_guards():
    for op in ("pack", "unpack", "pack_flat", "unpack_flat", "pack_words",
               "unpack_words"):
        assert dispatch.available(op) == ("cuda", "torch")
        assert dispatch.resolve(op, "auto", "cpu") is getattr(
            BP, op + "_plain")
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            dispatch.resolve(op, "cuda", "cpu")
    q = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel takes CUDA tensors"):
        BP.pack_words_cuda(q, 8)
    with pytest.raises(ValueError, match="CUDA kernel takes CUDA tensors"):
        BP.unpack_words_cuda(q, 40, 8)
    with pytest.raises(ValueError, match="bits must be one of"):
        BP.pack_words(q, 3)
    with pytest.raises(ValueError, match="int32 values expected"):
        BP.pack_words(q.to(torch.int64), 8)
    with pytest.raises(ValueError, match="hold at most"):
        BP.unpack_words(q, 41, 8)
    with pytest.raises(ValueError, match=r"\(R, 4, 128\)"):
        BP.pack(torch.zeros((7, 4, 128), dtype=torch.int32), 8)
