"""End to end: the port's facade (``device='cpu'``) against the reference's
``CEAZ(use_fused=True)``. Every CEAZCompressed field must match bitwise
(``assert_streams_bit_identical``) and the decoded bytes must be equal,
over fields x modes x dtypes x both pass-1 stats branches — the card
always takes the device-stats branch, so the CPU runs hold it to the
reference here. Records cross between the packages through
``repro_torch.convert`` and decode on the other side."""
import numpy as np
import pytest
import torch

from conftest import assert_streams_bit_identical
from repro.core import ceaz as RC
from repro.core import codebook as RCB
from repro.data import fields as RF
from repro_torch import convert
from repro_torch.core import ceaz as TC
from repro_torch.core import codebook as TCB
from repro_torch.kernels import dispatch
from repro_torch.obs import metrics as om
from repro_torch.runtime import fused as TF

REF_OFF = RCB.default_offline_codebook()
PORT_OFF = TCB.default_offline_codebook()

FIELDS = {
    "cesm": (RF.cesm_proxy(size="small"), {}),                  # 256x512
    "hacc": (RF.hacc_proxy(size="small"), {"chunk_bytes": 1 << 17}),
    "s3d": (RF.s3d_proxy(size="small"), {}),                    # 64^3
}


def _ref(**kw):
    return RC.CEAZ(RC.CEAZConfig(use_fused=True, **kw),
                   offline_codebook=REF_OFF)


def _port(**kw):
    return TC.CEAZ(TC.CEAZConfig(device="cpu", **kw),
                   offline_codebook=PORT_OFF)


def _port_compress(comp, x, stats_on_device):
    """The facade's fused encode with the stats branch pinned."""
    if stats_on_device is None:
        return comp.compress(x)
    bits = x.dtype.itemsize * 8
    return TF.compress_error_bounded(
        x, comp._abs_eb(x), comp.cfg.mode, comp._coder(),
        comp._chunk_values(bits), comp.cfg.block_size, device="cpu",
        adaptive=comp.cfg.adaptive, exact_build=comp.cfg.exact_build,
        stats_on_device=stats_on_device)


def _check(x, stats_on_device=None, **kw):
    ref, port = _ref(**kw), _port(**kw)
    cr = ref.compress(x)
    cp = _port_compress(port, x, stats_on_device)
    assert_streams_bit_identical(cr, cp)
    yr, yp = ref.decompress(cr), port.decompress(cp)
    assert yp.dtype == yr.dtype == x.dtype and yp.shape == x.shape
    assert yp.tobytes() == yr.tobytes()
    return cr, cp, yp


@pytest.mark.parametrize("stats_on_device", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode,eb", [("abs", 1e-3), ("rel", 1e-4)])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_streams_and_bytes_match_reference(name, mode, eb, dtype,
                                           stats_on_device):
    x, kw = FIELDS[name]
    x = x.astype(dtype)
    _, cp, y = _check(x, stats_on_device, mode=mode, eb=eb, **kw)
    if name == "hacc":
        assert len(cp.chunks) > 1
    bound = eb * (1.0 if mode == "abs" else TC.value_range(x))
    assert np.abs(y.astype(np.float64) - x.astype(np.float64)).max() <= bound


@pytest.mark.parametrize("fill", [np.nan, np.inf, -np.inf],
                         ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("stats_on_device", [False, True])
def test_all_nonfinite_inputs(fill, stats_on_device):
    x = np.full(5000, fill, np.float32)
    _, _, y = _check(x, stats_on_device, mode="abs", eb=1e-3,
                     chunk_bytes=1 << 12, block_size=512)
    if np.isinf(fill):
        assert np.array_equal(y, x)          # literals restore the infs


@pytest.mark.parametrize("stats_on_device", [False, True])
def test_nonfinite_mix_and_ragged_tails(stats_on_device):
    rng = np.random.default_rng(9)
    x = np.cumsum(rng.standard_normal(2 * 4096 + 300)).astype(np.float32)
    x[::97] = np.inf
    x[5::131] = np.nan
    x[7::151] = -3e9
    _check(x, stats_on_device, mode="rel", eb=1e-4, chunk_bytes=1 << 14,
           block_size=512)


def test_stats_branches_agree_on_literal_boundary_cases():
    """Regression for the device-stats branch: inputs sitting on
    f32 reconstruction midpoints (the literal channel's reason to exist)
    and float64 inputs whose f32 rounding moves them across a bin edge
    must produce the same literal set on both branches."""
    rng = np.random.default_rng(21)
    eb = 1e-3
    lv = (rng.integers(-4000, 4000, 20000) + 0.5) * (2 * np.float32(eb))
    x = (lv + rng.choice([-1, 0, 1], lv.size) * 1e-12).astype(np.float64)
    port = _port(mode="abs", eb=eb)
    a = _port_compress(port, x, False)
    b = _port_compress(port, x, True)
    assert_streams_bit_identical(a, b)
    assert len(a.literal_idx) > 0
    assert_streams_bit_identical(_ref(mode="abs", eb=eb).compress(x), a)


@pytest.mark.parametrize("shape", [(0,), (0, 7), (1,), (3, 1, 5, 7)])
def test_degenerate_shapes(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    _check(x, None, mode="rel", eb=1e-4)


@pytest.mark.parametrize("kw", [dict(adaptive=False),
                                dict(exact_build=True, tau0=0.5, tau1=4.0)])
def test_policy_options_match_reference(kw):
    """Always-rebuild and oracle-Huffman policies over several chunks."""
    x, fkw = FIELDS["hacc"]
    _check(x, True, mode="rel", eb=1e-4, **fkw, **kw)


def test_tiny_chunks_and_blocks():
    x = np.cumsum(np.random.default_rng(3).standard_normal(17)) \
        .astype(np.float32)
    cr, cp, _ = _check(x, None, mode="abs", eb=1e-3, chunk_bytes=4,
                       block_size=1)
    assert len(cp.chunks) == 17


def test_cross_decode_through_convert():
    x = FIELDS["hacc"][0]
    kw = dict(mode="rel", eb=1e-4, chunk_bytes=1 << 17)
    ref, port = _ref(**kw), _port(**kw)
    cr, cp = ref.compress(x), port.compress(x)
    # reference stream -> port decode
    from_ref = convert.from_reference(cr)
    assert isinstance(from_ref, TC.CEAZCompressed)
    assert port.decompress(from_ref).tobytes() == ref.decompress(cr).tobytes()
    # port stream -> reference decode
    f = convert.to_reference_fields(cp)
    f["chunks"] = [RC.CompressedChunk(**c) for c in f["chunks"]]
    back = RC.CEAZCompressed(**f)
    assert_streams_bit_identical(cr, back)
    assert ref.decompress(back).tobytes() == port.decompress(cp).tobytes()
    # codebooks carry across with their ids
    book = convert.from_reference(REF_OFF)
    assert book.id == REF_OFF.id
    assert RCB.Codebook(**convert.to_reference_fields(PORT_OFF)).id \
        == PORT_OFF.id


def test_offline_codebook_ids_match():
    assert PORT_OFF.id == REF_OFF.id
    np.testing.assert_array_equal(PORT_OFF.lengths, REF_OFF.lengths)
    np.testing.assert_array_equal(PORT_OFF.codes, REF_OFF.codes)


def test_facade_runs_on_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this case checks the refusal on a machine with no GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.CEAZ(TC.CEAZConfig(), offline_codebook=PORT_OFF)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.CEAZ(mode="abs", offline_codebook=PORT_OFF)
    assert TC.CEAZ(device="cpu", offline_codebook=PORT_OFF).device.type \
        == "cpu"
    with pytest.raises(ValueError, match="CUDA"):
        _port(kernel_impl="cuda").compress(np.ones(64, np.float32))


def _mesh_plans():
    """(a plan over a one-device mesh, a plan over two devices): the
    sharding plan of ROADMAP Queue 1 item 3; one process cannot drive the
    second (a rank mesh of processes does: tests/test_torch_dist.py)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.sharding import make_plan
    return (make_plan(make_mesh((1, 1), ("data", "model"), ["cpu"])),
            make_plan(make_mesh((2, 1), ("data", "model"),
                                ["cuda:0", "cuda:1"])))


@pytest.mark.parametrize("kw,item", [
    (dict(use_fused=False), "Queue 1 item 3"),
    (dict(use_fused=False, predictor="none"), "Queue 1 item 3"),
    (dict(use_fused=False, mode="fixed_ratio"), "Queue 1 item 3"),
])
def test_unported_routes_raise(kw, item):
    """The staged routes run (tests/test_torch_staged.py holds them to
    the reference), and so does a batch over a mesh plan (ROADMAP
    `item`, the sharding plan) that spans one device: its streams are
    plan=None's. One process cannot drive a mesh over two devices."""
    x = np.linspace(-1, 1, 64, dtype=np.float32)
    comp = _port(**kw)
    c = comp.compress(x)
    assert comp.decompress(c).tobytes() == _port(**kw).decompress(c) \
        .tobytes()
    assert comp.compress_batch([x, x], plan=object())[0].chunks
    one, two = _mesh_plans()
    for a, b in zip(comp.compress_batch([x, x], plan=one),
                    comp.compress_batch([x, x])):
        assert_streams_bit_identical(a, b)
    with pytest.raises(ValueError, match="one process a position"):
        comp.compress_batch([x, x], plan=two)


@pytest.mark.parametrize("kw", [
    dict(mode="fixed_ratio"),
    dict(mode="fixed_ratio", predictor="auto"),
    dict(mode="fixed_ratio", codebook="bank"),
], ids=["exact", "predictor-auto", "bank"])
def test_fixed_ratio_routes_match_reference(kw):
    """The routes that raised before fixed-ratio mode was ported: the
    facade's stream equals the reference's on a multi-chunk field."""
    x, fkw = FIELDS["hacc"]
    _, cp, y = _check(x, None, **kw, **fkw)
    assert len(cp.chunks) > 1 and cp.mode == "fixed_ratio"
    ebs = np.repeat([ch.eb for ch in cp.chunks],
                    [ch.n_values for ch in cp.chunks])
    assert np.all(np.abs(y.astype(np.float64) - x) <= ebs)


def test_unported_decode_and_batch_routes_raise():
    c = _port().compress(np.ones(64, np.float32))
    # the split route is ported: same bytes as the megakernel route
    assert _port(decode_megakernel="split").decompress(c).tobytes() \
        == _port().decompress(c).tobytes()
    # compress_batch is ported, over a one-device mesh plan too; one
    # process cannot drive a mesh over two devices
    ones = [np.ones(8, np.float32)] * 2
    one, two = _mesh_plans()
    assert len(_port().compress_batch(ones)) == 2
    for a, b in zip(_port().compress_batch(ones, plan=one),
                    _port().compress_batch(ones)):
        assert_streams_bit_identical(a, b)
    with pytest.raises(ValueError, match="one process a position"):
        _port().compress_batch(ones, plan=two)
    with pytest.raises(ValueError, match="backend"):
        _port(use_fused=False, backend="jax").compress(
            np.ones(64, np.float32))
    with pytest.raises(ValueError, match="speculation"):
        TC.CEAZ(device="cpu", offline_codebook=PORT_OFF, codebook="bank",
                mode="fixed_ratio", speculation="warp").compress(
                    np.ones(64, np.float32))
    with pytest.raises(TypeError):
        _port().compress(np.ones(8, np.int32))


def test_kernel_pass_accounting():
    """Every host-level pass feeds ceaz_kernel_calls_total per (op, impl);
    with timing on, the synced pass time lands in
    ceaz_kernel_pass_seconds (the reference dispatch layer's metrics)."""
    x = FIELDS["cesm"][0]
    before = om.snapshot()
    dispatch.set_timing(True)
    try:
        port = _port()
        port.decompress(port.compress(x))
    finally:
        dispatch.set_timing(False)
    d = om.diff(om.snapshot(), before)
    for op in ("dualquant", "hufenc", "ceaz_chunk_dec"):
        assert d[f'{om.KERNEL_CALLS}{{impl="torch",op="{op}"}}'] == 1
        assert any(k.startswith(om.KERNEL_SECONDS) and op in k for k in d)


def test_module_compress_and_decompress_match_reference():
    """``repro_torch.core.compress`` / ``decompress``, the one-line
    wrappers over the facade, against the reference's (their keyword
    arguments go to the config; the port's facade is fused by default,
    the reference's is asked)."""
    from repro import core as R
    from repro_torch import core as P
    x, kw = FIELDS["hacc"]
    cr = R.compress(x, mode="rel", eb=1e-4, use_fused=True, **kw)
    cp = P.compress(x, mode="rel", eb=1e-4, device="cpu", **kw)
    assert_streams_bit_identical(cr, cp)
    assert P.decompress(cp, device="cpu").tobytes() == \
        R.decompress(cr).tobytes()
