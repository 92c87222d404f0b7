"""Fixed-ratio mode: the port's facade (``device='cpu'``) against the
reference's ``CEAZ(mode='fixed_ratio', use_fused=True, backend='jax')``.

The same numpy inputs go to both packages. Every CEAZCompressed field
must match bitwise, and the decoded bytes must be equal through both of
the port's decode routes (the megakernel and the split route). Outputs
are integers or floats rebuilt from integers, so the tolerance is 0.
The grid: speculation 'off' / 2 / 'auto', exact and bank coders, f32
and f64, both pass-1 stats branches, on the small CESM, HACC and NWChem
proxies cut so the last chunk is partial."""
import functools

import numpy as np
import pytest

from conftest import assert_streams_bit_identical
from repro.core import ceaz as RC
from repro.core import codebook as RCB
from repro.data import fields as RF
from repro.obs import metrics as rom
from repro_torch import convert
from repro_torch.core import ceaz as TC
from repro_torch.core import codebook as TCB
from repro_torch.obs import metrics as tom
from repro_torch.runtime import fused as TF

REF_OFF = RCB.default_offline_codebook()
PORT_OFF = TCB.default_offline_codebook()
CHUNK_BYTES = 1 << 14              # 4096 values a chunk (the block floor)

FIELDS = {
    "cesm": lambda: RF.cesm_proxy(size="small")[:, :-3],      # 256x509
    "hacc": lambda: RF.hacc_proxy(size="small")[:-1000],
    "nwchem": lambda: RF.nwchem_proxy(size="small")[:-1000],
}
SPECS = ["off", 2, "auto"]


def _kw(spec, codebook, **extra):
    return {**dict(mode="fixed_ratio", target_ratio=10.0,
                   chunk_bytes=CHUNK_BYTES, speculation=spec,
                   codebook=codebook), **extra}


def _ref(**kw):
    return RC.CEAZ(RC.CEAZConfig(use_fused=True, backend="jax", **kw),
                   offline_codebook=REF_OFF)


def _port(**kw):
    return TC.CEAZ(TC.CEAZConfig(device="cpu", **kw),
                   offline_codebook=PORT_OFF)


@functools.lru_cache(maxsize=None)
def _field(name, dtype):
    return FIELDS[name]().astype(dtype)


@functools.lru_cache(maxsize=None)
def _ref_run(name, dtype, codebook, spec):
    """(stream, decoded bytes, speculation metrics) of the reference."""
    x = _field(name, dtype)
    ref = _ref(**_kw(spec, codebook))
    before = rom.snapshot()
    c = ref.compress(x)
    d = rom.diff(rom.snapshot(), before)
    return c, ref.decompress(c).tobytes(), _spec_metrics(d, rom)


def _spec_metrics(diff, om):
    return {k: diff.get(k, 0) for k in (om.SPEC_HITS, om.SPEC_MISSES)}


def _port_compress(port, x, stats_on_device, monkeypatch):
    """The facade's fixed-ratio compress with the stats branch pinned."""
    monkeypatch.setattr(TF, "compress_fixed_ratio", functools.partial(
        TF.compress_fixed_ratio, stats_on_device=stats_on_device))
    return port.compress(x)


def _assert_within_chunk_bounds(y, x, c):
    errs = np.abs(y.reshape(-1).astype(np.float64)
                  - x.reshape(-1).astype(np.float64))
    ebs = np.repeat([ch.eb for ch in c.chunks],
                    [ch.n_values for ch in c.chunks])
    assert np.all(errs <= ebs)


@pytest.mark.parametrize("stats_on_device", [False, True])
@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
@pytest.mark.parametrize("codebook", ["exact", "bank"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_fixed_ratio_streams_match_reference(name, dtype, codebook, spec,
                                             stats_on_device, monkeypatch):
    x = _field(name, dtype)
    cr, yr, ref_spec = _ref_run(name, dtype, codebook, spec)
    port = _port(**_kw(spec, codebook))
    before = tom.snapshot()
    cp = _port_compress(port, x, stats_on_device, monkeypatch)
    d = tom.diff(tom.snapshot(), before)
    assert_streams_bit_identical(cr, cp)
    assert [(a.bank_ref, a.bank_index) for a in cr.chunks] \
        == [(b.bank_ref, b.bank_index) for b in cp.chunks]
    assert _spec_metrics(d, tom) == ref_spec
    assert cp.chunks[-1].n_values < cp.chunks[0].n_values   # partial tail
    if codebook == "bank":
        assert all(ch.action == "bank" for ch in cp.chunks)
    for dmk in ("auto", "split"):
        y = _port(**_kw(spec, codebook), decode_megakernel=dmk) \
            .decompress(cp)
        assert y.dtype == x.dtype and y.shape == x.shape
        assert y.tobytes() == yr
    _assert_within_chunk_bounds(y, x, cp)


def _record_gauges(monkeypatch, om):
    seen = []
    orig = om.set_gauge

    def record(name, value, **labels):
        if name == om.SPEC_WINDOW:
            seen.append(value)
        return orig(name, value, **labels)
    monkeypatch.setattr(om, "set_gauge", record)
    return seen


@pytest.mark.parametrize("codebook", ["exact", "bank"])
def test_speculation_repairs_mispredicted_chunks(codebook, monkeypatch):
    """A stream whose forecasts miss: the port repairs the same chunks as
    the reference (hits and misses counted alike), walks the same window
    sequence, and still emits the sequential loop's stream."""
    x = (np.cumsum(np.random.default_rng(11).standard_normal(20 * 4096))
         / 10).astype(np.float32)
    kw = _kw("auto", codebook, target_ratio=8.0)
    ref_windows = _record_gauges(monkeypatch, rom)
    port_windows = _record_gauges(monkeypatch, tom)
    b_ref, b_port = rom.snapshot(), tom.snapshot()
    cr = _ref(**kw).compress(x)
    d_ref = rom.diff(rom.snapshot(), b_ref)
    cp = _port(**kw).compress(x)
    d_port = tom.diff(tom.snapshot(), b_port)
    assert_streams_bit_identical(cr, cp)
    assert d_port.get(tom.SPEC_MISSES, 0) > 0
    assert _spec_metrics(d_port, tom) == _spec_metrics(d_ref, rom)
    assert port_windows == ref_windows and len(port_windows) > 1
    assert_streams_bit_identical(_port(**_kw("off", codebook,
                                             target_ratio=8.0)).compress(x),
                                 cp)


def test_next_window_policy():
    assert TF._next_window(8, 0) == 16
    assert TF._next_window(TF._SPEC_WINDOW_MAX, 0) == TF._SPEC_WINDOW_MAX
    assert TF._next_window(8, 3) == 4
    assert TF._next_window(TF._SPEC_WINDOW_MIN, 1) == TF._SPEC_WINDOW_MIN
    assert [TF._spec_window(s) for s in ("off", "auto", 5)] == [1, 8, 5]
    for bad in ("warp", 0, True, 2.0):
        with pytest.raises(ValueError, match="speculation"):
            TF._spec_window(bad)


def test_fixed_ratio_tracks_target_ratio():
    """The achieved ratio stays inside the paper's 15% envelope on a
    multi-chunk stream (the reference's own acceptance check)."""
    x = (np.cumsum(np.random.default_rng(11).standard_normal(32 * 8192))
         / 10).astype(np.float32)
    for target in (6.0, 10.5):
        c = _port(mode="fixed_ratio", target_ratio=target,
                  chunk_bytes=1 << 15).compress(x)
        assert abs(c.ratio() / target - 1) <= 0.15, (target, c.ratio())


def test_fixed_ratio_ignores_predictor_and_handles_tiny_inputs():
    x = _field("hacc", np.float32)[:3000]          # one partial chunk
    for pred in ("none", "auto"):
        cp = _port(**_kw("auto", "exact"), predictor=pred).compress(x)
        assert cp.predictor == "lorenzo"
        assert_streams_bit_identical(
            _ref(**_kw("auto", "exact"), predictor=pred).compress(x), cp)
    empty = _port(**_kw("auto", "exact")).compress(np.zeros(0, np.float32))
    assert empty.mode == "fixed_ratio" and empty.chunks == []
    assert _port(mode="fixed_ratio").decompress(empty).shape == (0,)


def test_fixed_ratio_records_cross_through_convert():
    """Fixed-ratio records carry a per-chunk eb and no centre; they
    convert both ways and decode to the same bytes on either side."""
    x = _field("hacc", np.float32)
    kw = _kw("auto", "exact")
    ref, port = _ref(**kw), _port(**kw)
    cr, cp = ref.compress(x), port.compress(x)
    assert len({ch.eb for ch in cp.chunks}) > 1
    from_ref = convert.from_reference(cr)
    assert_streams_bit_identical(cr, from_ref)
    assert port.decompress(from_ref).tobytes() \
        == ref.decompress(cr).tobytes()
    f = convert.to_reference_fields(cp)
    f["chunks"] = [RC.CompressedChunk(**c) for c in f["chunks"]]
    back = RC.CEAZCompressed(**f)
    assert_streams_bit_identical(cp, back)
    assert ref.decompress(back).tobytes() == port.decompress(cp).tobytes()


def test_entry_points_run_on_the_card_unless_asked_for_cpu():
    """compress_fixed_ratio and the split decode default to the card and
    raise on a machine without one."""
    import torch
    from repro_torch.core.codebook import AdaptiveCoder
    from repro_torch.core.ratecontrol import FixedRatioController
    from repro_torch.runtime import fused_decode as TFD
    if torch.cuda.is_available():
        pytest.skip("this case checks the refusal on a machine with no GPU")
    x = _field("hacc", np.float32)[:8192]
    mk = lambda: (x, FixedRatioController(target_bitrate=3.2, eb=1e-2),
                  AdaptiveCoder(PORT_OFF), 4096, 1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.compress_fixed_ratio(*mk())
    c = TF.compress_fixed_ratio(*mk(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TFD.decompress_batch([c], 1024, PORT_OFF, megakernel=False)
    assert TFD.decompress_batch([c], 1024, PORT_OFF, device="cpu",
                                megakernel=False)[0].shape == x.shape
