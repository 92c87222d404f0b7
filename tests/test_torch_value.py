"""Value-direct prediction (``predictor='none'``) in the port against the
JAX reference: the `dq_center` op (sort-based plain version vs the
reference's ``chunk_center`` and its radix-select Pallas kernel in
interpret mode), the tiled value quantize/finalize steps, the core
twins, and the exact route end to end (``CEAZ(predictor='none'|'auto')``
vs the reference's ``CEAZ(use_fused=True)``). Inputs are numpy-seeded
and fed to both packages; every compared output is an integer or a
decoded byte, so every comparison is bitwise (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_streams_bit_identical
from repro.core import ceaz as RC
from repro.core import codebook as RCB
from repro.core import dualquant as RD
from repro.kernels.dualquant import kernel as RDK
from repro.kernels.dualquant import ops as RDO
from repro.kernels.megakernel import kernel as RMK
from repro_torch import convert
from repro_torch.core import ceaz as TC
from repro_torch.core import codebook as TCB
from repro_torch.core import dualquant as TD
from repro_torch.kernels import dispatch
from repro_torch.kernels.dualquant import ops as TDO
from repro_torch.kernels.megakernel import ops as TMK
from repro_torch.runtime import fused as TF

REF_OFF = RCB.default_offline_codebook()
PORT_OFF = TCB.default_offline_codebook()
I32 = np.iinfo(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module's small arrays: the suite runs
    its files in parallel workers, and timing tests share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _center_rows(seed):
    """(q2, valid2) rows covering the centre's corner cases."""
    rng = np.random.default_rng(seed)
    V = 4096
    rows, masks = [], []

    def add(q, m):
        rows.append(np.asarray(q, np.int64).astype(np.int32))
        masks.append(np.asarray(m, bool))

    full = np.ones(V, bool)
    add(rng.integers(-5, 6, V), full)                    # heavy ties, even m
    prefix = np.arange(V) < 2999
    add(rng.integers(-1000, 1000, V), prefix)            # padded, odd m
    add(rng.integers(-1000, 1000, V), np.zeros(V, bool))  # no valid entry
    wrap = np.zeros(V, np.int64)
    wrap[:2] = (-2_000_000_000, 2_000_000_000)           # hi - lo wraps
    add(wrap, np.arange(V) < 2)
    edge = rng.choice([I32.min, I32.min + 1, I32.max - 1, I32.max], V)
    add(edge, full)                                      # near +-2^31
    add(edge, rng.random(V) < 0.5)                       # scattered mask
    add(rng.integers(I32.min, I32.max, V, endpoint=True), np.arange(V) < 1)
    add(np.full(V, 7), np.arange(V) < 2)                 # all equal
    return np.stack(rows), np.stack(masks)


def test_chunk_center_plain_matches_reference_and_pallas_kernel():
    q2, valid2 = _center_rows(0)
    port = TDO.chunk_center_plain(_t(q2), _t(valid2)).numpy()
    ref = np.asarray(RDO.chunk_center(jnp.asarray(q2), jnp.asarray(valid2)))
    kern = np.asarray(RDK.dq_center(jnp.asarray(q2), jnp.asarray(valid2),
                                    interpret=True))
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, kern)
    assert port[2] == 0                           # zero-valid row
    assert port[3] == np.int32(-2_147_483_648)    # the wrapped midpoint


def test_dq_center_op_resolves_by_device():
    q2, valid2 = _center_rows(1)
    fn = dispatch.resolve("dq_center", "auto", "cpu")
    assert fn is TDO.chunk_center_plain
    with pytest.raises(ValueError, match="CUDA"):
        TDO.dq_center_cuda(_t(q2), _t(valid2))


def _value_rows(seed, C=2, seg=1024, ns=2):
    rng = np.random.default_rng(seed)
    cvp = seg * ns
    work = (rng.standard_normal((C, cvp)) * 0.05).astype(np.float32)
    work[0, ::53] = np.nan
    work[0, 1::71] = np.inf
    work[1, 2::89] = -3e9
    valid = np.ones((C, cvp), bool)
    valid[-1, cvp - 777:] = False
    work[~valid] = 0.0
    ebs = np.array([1e-3, 3.7e-4], np.float32)[:C]
    return work, valid, ebs


def test_value_quant_plain_matches_value_quant_tiles():
    work, _, ebs = _value_rows(2)
    ref = np.asarray(RMK.value_quant_tiles(
        jnp.asarray(work), jnp.asarray(ebs[:, None]), seg=1024,
        interpret=True))
    port = TMK.value_quant_plain(_t(work), _t(ebs)).numpy()
    np.testing.assert_array_equal(port, ref)


def test_value_finalize_plain_matches_value_finalize_tiles():
    work, valid, ebs = _value_rows(3)
    q2 = TMK.value_quant_plain(_t(work), _t(ebs))
    centers = TDO.chunk_center_plain(q2, _t(valid))
    qm, codes, outl, delta, hists = TMK.value_finalize_plain(
        q2, _t(valid), centers)
    r_codes, r_outl, r_delta, r_hists = (np.asarray(a) for a in
                                         RMK.value_finalize_tiles(
        jnp.asarray(q2.numpy()), jnp.asarray(valid.astype(np.int32)),
        jnp.asarray(centers.numpy()), seg=1024, interpret=True))
    np.testing.assert_array_equal(codes.numpy(), r_codes)
    np.testing.assert_array_equal(outl.numpy(), r_outl.astype(bool))
    np.testing.assert_array_equal(delta.numpy(), r_delta)
    np.testing.assert_array_equal(hists.numpy(), r_hists)
    np.testing.assert_array_equal(qm.numpy(), np.where(valid, q2.numpy(), 0))
    assert outl.numpy().any()


@pytest.mark.parametrize("eb", [1e-3, 0.37])
def test_value_quantize_twin_matches_reference(eb):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(5000) * 0.1).astype(np.float32)
    x[::97] = np.nan
    x[5::131] = 3e9
    ref = RD.value_quantize(x, eb)
    port = TD.value_quantize(x, eb, device="cpu")
    np.testing.assert_array_equal(port[0], ref[0].astype(np.int32))
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_array_equal(port[2], ref[2])
    assert port[3] == ref[3]
    d = port[2].astype(np.int64)
    np.testing.assert_array_equal(
        TD.np_value_dequantize(d, port[3], eb),
        RD.np_value_dequantize(d, ref[3], eb))


# ---------------------------------------------------------------------------
# The exact route end to end
# ---------------------------------------------------------------------------

def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


def _walk(shape, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)


FIELDS = {
    "noise1d": (_noise(3 * 4096 + 123, 5), {"chunk_bytes": 1 << 14}),
    "noise2d": (_noise((64, 96), 6), {}),
    "walk1d": (_walk(2 * 4096 + 7, 7), {"chunk_bytes": 1 << 14}),
}


def _port_compress(comp, x, stats_on_device):
    if stats_on_device is None:
        return comp.compress(x)
    return TF.compress_error_bounded(
        x, comp._abs_eb(x), comp.cfg.mode, comp._coder(),
        comp._chunk_values(x.dtype.itemsize * 8), comp.cfg.block_size,
        device="cpu", stats_on_device=stats_on_device,
        predictor=comp._pick_predictor(x, comp._abs_eb(x)))


def _check(x, stats_on_device=None, **kw):
    ref = RC.CEAZ(RC.CEAZConfig(use_fused=True, **kw),
                  offline_codebook=REF_OFF)
    port = TC.CEAZ(TC.CEAZConfig(device="cpu", **kw),
                   offline_codebook=PORT_OFF)
    cr = ref.compress(x)
    cp = _port_compress(port, x, stats_on_device)
    assert_streams_bit_identical(cr, cp)
    yr, yp = ref.decompress(cr), port.decompress(cp)
    assert yp.dtype == x.dtype and yp.shape == x.shape
    assert yp.tobytes() == yr.tobytes()
    return cr, cp, yp


@pytest.mark.parametrize("stats_on_device", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode,eb", [("abs", 1e-3), ("rel", 1e-4)])
@pytest.mark.parametrize("name", ["noise1d", "noise2d"])
def test_exact_value_direct_matches_reference(name, mode, eb, dtype,
                                              stats_on_device):
    x, kw = FIELDS[name]
    x = x.astype(dtype)
    _, cp, y = _check(x, stats_on_device, mode=mode, eb=eb,
                      predictor="none", **kw)
    assert cp.predictor == "none" and cp.ndim == 1
    assert len({ch.center for ch in cp.chunks}) >= 1
    bound = eb * (1.0 if mode == "abs" else TC.value_range(x))
    assert np.abs(y.astype(np.float64) - x.astype(np.float64)).max() <= bound


@pytest.mark.parametrize("name,want", [("noise1d", "none"),
                                       ("walk1d", "lorenzo")])
def test_auto_predictor_matches_reference(name, want):
    x, kw = FIELDS[name]
    _, cp, _ = _check(x, None, mode="rel", eb=1e-3, predictor="auto", **kw)
    assert cp.predictor == want


def test_value_direct_nonfinite_and_empty():
    x = _noise(5000, 8)
    x[::97] = np.nan
    x[3::101] = np.inf
    _check(x, None, mode="abs", eb=1e-3, predictor="none",
           chunk_bytes=1 << 12, block_size=512)
    _, cp, _ = _check(np.zeros(0, np.float32), None, predictor="none")
    assert cp.predictor == "none" and not cp.chunks


def test_cross_decode_value_stream_through_convert():
    x, kw = FIELDS["noise1d"]
    kw = dict(mode="rel", eb=1e-4, predictor="none", **kw)
    ref = RC.CEAZ(RC.CEAZConfig(use_fused=True, **kw),
                  offline_codebook=REF_OFF)
    port = TC.CEAZ(TC.CEAZConfig(device="cpu", **kw),
                   offline_codebook=PORT_OFF)
    cr = ref.compress(x)
    assert port.decompress(convert.from_reference(cr)).tobytes() \
        == ref.decompress(cr).tobytes()
    f = convert.to_reference_fields(port.compress(x))
    f["chunks"] = [RC.CompressedChunk(**c) for c in f["chunks"]]
    back = RC.CEAZCompressed(**f)
    assert_streams_bit_identical(cr, back)
    assert [c.center for c in back.chunks] == [c.center for c in cr.chunks]


def test_runtime_entry_points_default_to_the_card():
    """The runtime entry points run on the card unless asked for the CPU
    (the facade passes its device; any other caller gets the card)."""
    if torch.cuda.is_available():
        pytest.skip("this case checks the refusal on a machine with no GPU")
    from repro_torch.runtime import fused_decode as TFD
    x = _noise(4096, 9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.compress_error_bounded(x, 1e-3, "abs", TCB.AdaptiveCoder(PORT_OFF),
                                  4096, 4096)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.compress_error_bounded_bank(
            x, 1e-3, "abs", TCB.BankCoder(TCB.default_codebook_bank()),
            4096, 4096)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.value_quantize(x, 1e-3)
    assert TD.value_quantize(x, 1e-3, device="cpu")[0].shape == x.shape
    c = TF.compress_error_bounded(x, 1e-3, "abs", TCB.AdaptiveCoder(PORT_OFF),
                                  4096, 4096, device="cpu", predictor="none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TFD.decompress_batch([c], 4096, PORT_OFF)
    assert TFD.decompress_batch([c], 4096, PORT_OFF, device="cpu")[0].shape \
        == x.shape
