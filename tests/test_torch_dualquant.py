"""Pass-1 parity: the port's dual-quant twin and its `dualquant` op against
the reference's jnp dual-quantizer and its Pallas kernels (interpret
mode). Inputs are numpy-seeded and fed to both; every output is an
integer, so every comparison is bitwise (tolerance 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dualquant as RD
from repro.kernels.dualquant import kernel as RK
from repro_torch.core import dualquant as TD
from repro_torch.kernels import dispatch
from repro_torch.kernels.dualquant import ops as TO


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    for ax in range(len(shape)):
        x = np.cumsum(x, axis=ax).astype(np.float32)
    return x / np.float32(np.sqrt(x.size))


def _nonfinite(shape, seed):
    x = _field(shape, seed).reshape(-1).copy()
    x[::7] = np.nan
    x[1::11] = np.inf
    x[2::13] = -np.inf
    x[3::17] = 3e9
    x[4::19] = -3e9
    return x.reshape(shape)


def _ref(x, eb, ndim):
    codes, outl, delta = RD.dual_quantize(jnp.asarray(x), eb, ndim)
    q = RD.inverse_lorenzo(delta, ndim)
    return [np.asarray(a) for a in (codes, outl, delta, q)]


def _port(x, eb, ndim):
    return [t.numpy() for t in TD.dual_quantize(torch.from_numpy(x), eb,
                                                ndim)]


def _assert_same(ref, port):
    codes, outl, delta, q = ref
    np.testing.assert_array_equal(port[0], codes.astype(np.int32))
    np.testing.assert_array_equal(port[1], outl)
    np.testing.assert_array_equal(port[2], delta)
    np.testing.assert_array_equal(port[3], q)


@pytest.mark.parametrize("shape", [(1,), (4099,), (100003,), (37, 211),
                                   (256, 512), (9, 10, 11), (32, 33, 34)])
@pytest.mark.parametrize("eb", [1e-2, 3.7e-4, 1e-5])
def test_twin_matches_reference(shape, eb):
    x = _field(shape, len(shape) * 1000 + shape[0])
    _assert_same(_ref(x, eb, len(shape)), _port(x, eb, len(shape)))


@pytest.mark.parametrize("shape", [(5000,), (61, 83), (13, 14, 15)])
def test_twin_on_nonfinite_and_huge_inputs(shape):
    """NaN quantizes to 0 (XLA's float->int cast), +-Inf and +-3e9 clip
    to +-2e9 — the torch CPU cast would give INT32_MIN for NaN."""
    x = _nonfinite(shape, 7)
    ref = _ref(x, 1e-3, len(shape))
    port = _port(x, 1e-3, len(shape))
    _assert_same(ref, port)
    q = np.asarray(jax.jit(RD.prequantize)(jnp.asarray(x), 1e-3))
    assert (q[np.isnan(x)] == 0).all() and np.isnan(x).any()
    np.testing.assert_array_equal(
        TD.prequantize(torch.from_numpy(x), 1e-3).numpy(), q)


@pytest.mark.parametrize("shape", [(8, 512), (16, 1536)])
@pytest.mark.parametrize("eb", [1e-2, 1e-4])
def test_twin_matches_pallas_dq1d_rows(shape, eb):
    """dq1d resets prediction per row; the twin on each row is that."""
    x = _field(shape, 3)
    codes, outl, delta = (np.asarray(a) for a in
                          RK.dq1d(jnp.asarray(x), eb, interpret=True))
    for r in range(shape[0]):
        pc, po, pd, _ = _port(np.ascontiguousarray(x[r]), eb, 1)
        np.testing.assert_array_equal(pc, codes[r])
        np.testing.assert_array_equal(po, outl[r].astype(bool))
        np.testing.assert_array_equal(pd, delta[r])


@pytest.mark.parametrize("shape,nonfinite", [((8, 512), False),
                                             ((24, 1024), False),
                                             ((16, 512), True)])
def test_op_matches_pallas_dq2d(shape, nonfinite):
    """The `dualquant` op's plain version (what the card's dq2d kernel is
    held against) vs the Pallas dq2d kernel, padded layout included."""
    x = (_nonfinite if nonfinite else _field)(shape, 5)
    eb = 1e-3
    codes, outl, delta = (np.asarray(a).reshape(-1) for a in
                          RK.dq2d(jnp.asarray(x), eb, interpret=True))
    op = dispatch.resolve("dualquant", "auto", "cpu")
    n_out = x.size + 100
    pc, po, pd, pq = (t.numpy() for t in
                      op(torch.from_numpy(x), eb, 2, n_out))
    np.testing.assert_array_equal(pc[:x.size], codes)
    np.testing.assert_array_equal(po[:x.size], outl.astype(bool))
    np.testing.assert_array_equal(pd[:x.size], delta)
    assert not pc[x.size:].any() and not po[x.size:].any()
    assert not pd[x.size:].any() and pq.shape == (x.size,)


def test_cuda_impl_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.resolve("dualquant", "cuda", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        TO.dual_quantize_cuda(torch.zeros(8), 1e-3, 1, 8)
    assert dispatch.resolve("dualquant", "auto", "cpu") \
        is TO.dual_quantize_plain
    with pytest.raises(ValueError, match="kernel_impl"):
        dispatch.resolve("dualquant", "pallas", "cpu")


@pytest.mark.parametrize("shape,ndim", [((5000,), 1), ((60, 70), 2),
                                        ((12, 13, 14), 3)])
def test_dequantize_and_deltas_from_codes_match_reference(shape, ndim):
    """``dequantize`` (the inverse Lorenzo times 2 eb in f32) and
    ``deltas_from_codes`` (in-band codes and dense outlier deltas merged)
    bitwise against the reference's, on a field with outliers."""
    x = _nonfinite(shape, 4)
    x = np.where(np.isfinite(x) & (np.abs(x) < 1e3), x * 50, 0.0)
    x = x.astype(np.float32)
    eb = 1e-3
    codes, outl, delta = RD.dual_quantize(jnp.asarray(x), eb, ndim)
    assert bool(np.asarray(outl).any())
    dense = np.where(np.asarray(outl), np.asarray(delta), 0).astype(np.int32)
    ref_d = np.asarray(RD.deltas_from_codes(codes, jnp.asarray(dense)))
    got_d = TD.deltas_from_codes(torch.from_numpy(np.asarray(codes)),
                                 torch.from_numpy(dense))
    assert got_d.dtype == torch.int32
    assert np.array_equal(got_d.numpy(), ref_d)
    assert np.array_equal(ref_d, np.asarray(delta))
    ref = np.asarray(RD.dequantize(jnp.asarray(ref_d), eb, ndim))
    got = TD.dequantize(got_d, eb, ndim)
    assert got.dtype == torch.float32 and got.shape == shape
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    assert np.abs(got.numpy() - x).max() <= eb * (1 + 1e-6)
