"""The staged route (``use_fused=False``) of the port's facade
(``device='cpu'``) against the reference's, backend by backend: the
port's ``'numpy'`` against the reference's ``'numpy'``, the port's
``'torch'`` against the reference's ``'jax'`` (and one ``'pallas'``
cell). Every CEAZCompressed field must match bitwise
(``assert_streams_bit_identical``) and the decoded bytes must equal the
reference's staged decode. The port's ``'torch'`` stream must also equal
its own fused route's, as the reference's ``'jax'`` equals its fused.

The two backend pairs are not interchangeable: compiled XLA rounds
``x - q*2eb`` once (a fused multiply-add) where numpy rounds twice, so
at f32 midpoints ``'numpy'`` and ``'torch'`` give different streams
(:func:`test_midpoint_cell_separates_the_backends`)."""
import numpy as np
import pytest

from conftest import assert_streams_bit_identical
from repro.core import ceaz as RC
from repro.core import codebook as RCB
from repro.core import huffman as RH
from repro.data import fields as RF
from repro_torch import convert
from repro_torch.core import ceaz as TC
from repro_torch.core import codebook as TCB
from repro_torch.runtime import fused_decode as FD

REF_OFF = RCB.default_offline_codebook()
PORT_OFF = TCB.default_offline_codebook()
PAIRS = {"numpy": "numpy", "torch": "jax"}     # port backend -> reference's
# a smooth 64x300 field in several chunks with ragged tails (block 1024:
# f32 chunks of 4096 values, f64 chunks of 2048)
GRID = dict(chunk_bytes=1 << 14, block_size=1024)


def _field(dtype=np.float32, seed=0, shape=(64, 300)):
    rng = np.random.default_rng(seed)
    x = np.cumsum(np.cumsum(rng.standard_normal(shape), 0), 1) * 1e-2
    return x.astype(dtype)


def _ref(backend, offline=REF_OFF, **kw):
    return RC.CEAZ(RC.CEAZConfig(use_fused=False, backend=backend, **kw),
                   offline_codebook=offline)


def _port(backend="torch", offline=PORT_OFF, **kw):
    return TC.CEAZ(TC.CEAZConfig(device="cpu", use_fused=False,
                                 backend=backend, **kw),
                   offline_codebook=offline)


def _check(x, backend, ref_backend=None, **kw):
    """The port's staged stream and decoded bytes vs the reference's."""
    ref, port = _ref(ref_backend or PAIRS[backend], **kw), _port(backend, **kw)
    cr, cp = ref.compress(x), port.compress(x)
    assert_streams_bit_identical(cr, cp)
    yr, yp = ref.decompress(cr), port.decompress(cp)
    assert yp.dtype == yr.dtype == x.dtype and yp.shape == x.shape
    assert yp.tobytes() == yr.tobytes()
    return cp, yp


def _cells():
    out = []
    for mode in ("abs", "rel", "fixed_ratio"):
        for pred in (("lorenzo",) if mode == "fixed_ratio"
                     else ("lorenzo", "none", "auto")):
            out.append((mode, pred))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode,predictor", _cells())
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_staged_grid_matches_reference(backend, mode, predictor, dtype):
    x = _field(dtype)
    eb = 1e-3 if mode == "abs" else 1e-4
    kw = dict(mode=mode, eb=eb, predictor=predictor, **GRID)
    cp, y = _check(x, backend, **kw)
    assert len(cp.chunks) > 1
    assert cp.chunks[-1].n_values < cp.chunks[0].n_values     # ragged tail
    if mode != "fixed_ratio":
        bound = eb * (1.0 if mode == "abs" else TC.value_range(x))
        assert np.abs(y.astype(np.float64) - x).max() <= bound


@pytest.mark.parametrize("mode,predictor", _cells())
def test_staged_torch_equals_fused(mode, predictor):
    """The reference's contract, held by the port: staged 'torch' and
    the fused route emit the same stream."""
    x = _field()
    kw = dict(mode=mode, eb=1e-4, predictor=predictor, **GRID)
    staged = _port("torch", **kw).compress(x)
    fused = TC.CEAZ(TC.CEAZConfig(device="cpu", **kw),
                    offline_codebook=PORT_OFF).compress(x)
    assert_streams_bit_identical(staged, fused)


@pytest.mark.parametrize("kw", [dict(adaptive=False),
                                dict(exact_build=True),
                                dict(adaptive=False, exact_build=True)],
                         ids=["rebuild", "exact-build", "rebuild-exact"])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_policy_switches_match_reference(backend, kw):
    for mode in ("rel", "fixed_ratio"):
        cp, _ = _check(_field(), backend, mode=mode, **GRID, **kw)
        if kw.get("adaptive") is False:
            assert {ch.action for ch in cp.chunks} == {"rebuild"}


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_bank_mode_and_its_drift_fallback(backend):
    """The bank coder on the staged route; at a tolerance it cannot meet
    the whole array falls back to the exact coder."""
    x = _field()
    cp, _ = _check(x, backend, codebook="bank", **GRID)
    assert {ch.action for ch in cp.chunks} == {"bank"}
    cp, _ = _check(x, backend, codebook="bank", bank_drift_tol=-1.0, **GRID)
    assert "bank" not in {ch.action for ch in cp.chunks}


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_4d_empty_and_nonfinite_inputs(backend):
    x4 = _field(shape=(3, 4, 20, 30))
    cp, _ = _check(x4, backend, **GRID)
    assert cp.ndim == 3
    cp, y = _check(np.zeros((0, 7), np.float32), backend)
    assert not cp.chunks and y.shape == (0, 7)
    x = _field()
    x[3, 5], x[10, 100], x[40, 7] = np.nan, np.inf, -np.inf
    for predictor in ("lorenzo", "none"):
        _check(x, backend, predictor=predictor, **GRID)


def test_pallas_backend_cell():
    """One small cell against the reference's Pallas staged backend
    (its dual-quant kernel in interpret mode)."""
    _check(_field(shape=(32, 200)), "torch", ref_backend="pallas", **GRID)


def test_midpoint_cell_separates_the_backends():
    """cesm at rel 1e-4 (the cell where the fused twin first differed,
    at flat index 496): the backends' streams differ, and each equals
    its own reference backend's."""
    x = RF.cesm_proxy(size="small")
    kw = dict(mode="rel", eb=1e-4)
    c_np, _ = _check(x, "numpy", **kw)
    c_t, _ = _check(x, "torch", **kw)
    assert not np.array_equal(c_np.chunks[0].words, c_t.chunks[0].words)


def test_short_offline_book_decodes_through_the_staged_fallback():
    """An offline codebook limited to 12 bits: the fused decoders take
    only 16-bit books, so the facade decodes its streams on the staged
    route, as the reference does."""
    ref_off = RH.Codebook.from_freqs(
        np.bincount(np.clip(np.random.default_rng(4).normal(512, 20, 10**5),
                            0, 1023).astype(np.int64), minlength=1024),
        max_len=12)
    port_off = convert.from_reference(ref_off)
    x = _field()
    ref = RC.CEAZ(RC.CEAZConfig(use_fused=True, **GRID),
                  offline_codebook=ref_off)
    port = TC.CEAZ(TC.CEAZConfig(device="cpu", **GRID),
                   offline_codebook=port_off)
    cr, cp = ref.compress(x), port.compress(x)
    assert_streams_bit_identical(cr, cp)
    assert cp.chunks[0].action == "offline"
    assert not FD.fused_decode_ok(cp, port_off)
    assert port.decompress(cp).tobytes() == ref.decompress(cr).tobytes()
    # the staged route's stream with that book is the fused route's
    cs = _port("torch", offline=port_off, **GRID).compress(x)
    assert_streams_bit_identical(cs, cp)


def test_unknown_backend_raises():
    for name in ("jax", "pallas", "cupy"):
        with pytest.raises(ValueError, match="backend"):
            _port(name).compress(_field())
