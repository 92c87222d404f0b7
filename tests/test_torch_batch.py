"""``CEAZ.compress_batch`` of the port (``device='cpu'``, ``plan=None``)
against the reference's: every shard's stream bitwise
(``assert_streams_bit_identical``), equal to the port's own per-shard
``compress``, decoded to the reference's bytes, with the chunk/byte
counters moving exactly as the reference's do."""
import numpy as np
import pytest

from conftest import assert_streams_bit_identical
from repro.core import ceaz as RC
from repro.core import codebook as RCB
from repro.obs import metrics as RM
from repro_torch.core import ceaz as TC
from repro_torch.core import codebook as TCB
from repro_torch.obs import metrics as TM

REF_OFF = RCB.default_offline_codebook()
PORT_OFF = TCB.default_offline_codebook()
COUNTERS = ("CHUNKS", "RAW_BYTES", "STORED_BYTES")


def _shards(kind, seed=0):
    rng = np.random.default_rng(seed)
    walk = lambda *s: np.cumsum(rng.standard_normal(s), axis=-1) * 1e-2
    if kind == "group":                     # 3 same-shape shards
        return [walk(40, 150).astype(np.float32) for _ in range(3)]
    if kind == "singleton":
        return [walk(5000).astype(np.float32)]
    if kind == "ragged":                    # a group of 2 and a singleton
        return [walk(5000).astype(np.float32), walk(3001).astype(np.float32),
                walk(5000).astype(np.float32)]
    if kind == "f64":
        return [walk(4000).astype(np.float64) for _ in range(2)]
    if kind == "mixed":                     # f32 and f64 of one shape
        return [walk(4000).astype(np.float32), walk(4000).astype(np.float64),
                walk(4000).astype(np.float32)]
    raise ValueError(kind)


def _counts(metrics):
    return [metrics.counter(getattr(metrics, k)).value() for k in COUNTERS]


def _check(shards, **kw):
    rkw = {"use_fused": True, **kw}
    if not rkw["use_fused"]:    # the staged route: the matching backend
        rkw["backend"] = {"torch": "jax", "numpy": "numpy"}[
            kw.get("backend", "torch")]
    ref = RC.CEAZ(RC.CEAZConfig(**rkw), offline_codebook=REF_OFF)
    port = TC.CEAZ(TC.CEAZConfig(device="cpu", **kw),
                   offline_codebook=PORT_OFF)
    r0, p0 = _counts(RM), _counts(TM)
    cr = ref.compress_batch(shards)
    cp = port.compress_batch(shards)
    r1, p1 = _counts(RM), _counts(TM)
    assert [b - a for a, b in zip(p0, p1)] == [b - a for a, b in zip(r0, r1)]
    assert len(cp) == len(shards)
    for a, b, s in zip(cr, cp, shards):
        assert_streams_bit_identical(a, b)
        assert_streams_bit_identical(port.compress(s), b)
        assert port.decompress(b).tobytes() == ref.decompress(a).tobytes()
    return cp


@pytest.mark.parametrize("kind", ["group", "singleton", "ragged", "f64",
                                  "mixed"])
@pytest.mark.parametrize("predictor", ["lorenzo", "none", "auto"])
def test_batches_match_reference(kind, predictor):
    _check(_shards(kind), predictor=predictor, chunk_bytes=1 << 13,
           block_size=1024)


@pytest.mark.parametrize("kw", [
    dict(mode="abs", eb=1e-3, adaptive=False),
    dict(exact_build=True, tau0=0.5),
    dict(mode="fixed_ratio", chunk_bytes=1 << 13),
    dict(codebook="bank", chunk_bytes=1 << 13),
    dict(use_fused=False, chunk_bytes=1 << 13),
    dict(use_fused=False, backend="numpy", predictor="none"),
], ids=["abs-rebuild", "exact-build", "fixed-ratio", "bank", "staged",
        "staged-numpy"])
def test_other_routes_go_per_shard(kw):
    """Fixed ratio, bank mode and the staged route go shard by shard
    through compress(), as in the reference."""
    _check(_shards("ragged"), **kw)


def test_group_runs_one_pass_pair():
    """A group of three runs pass 1 once a shard, but one histogram and
    one pack for all of them (counted per host-level op pass)."""
    port = TC.CEAZ(TC.CEAZConfig(device="cpu", chunk_bytes=1 << 13,
                                 block_size=1024), offline_codebook=PORT_OFF)
    shards = _shards("group")
    before = TM.snapshot()
    from repro_torch.runtime import fused
    outs = fused.batch_compress(shards, 1e-4, 2048, 1024, PORT_OFF,
                                device="cpu", stats_on_device=True)
    d = TM.diff(TM.snapshot(), before)
    calls = lambda op: d.get(f'{TM.KERNEL_CALLS}{{impl="torch",op="{op}"}}')
    assert (calls("dualquant"), calls("histogram"), calls("hufenc")) \
        == (3, 1, 1)
    for s, c in zip(shards, outs):
        assert_streams_bit_identical(port.compress(s), c)


def test_mesh_plan_raises_and_batch_checks_shapes():
    """A plan over a one-device mesh batches there with plan=None's
    streams (the batched pass included); one process cannot drive a mesh
    over two devices (a rank mesh of processes does:
    tests/test_torch_dist.py)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.sharding import make_plan
    port = TC.CEAZ(TC.CEAZConfig(device="cpu"), offline_codebook=PORT_OFF)
    one = make_plan(make_mesh((1,), ("data",), ["cpu"]))
    two = make_plan(make_mesh((2,), ("data",), ["cuda:0", "cuda:1"]))
    shards = _shards("group")
    for a, b in zip(port.compress_batch(shards, plan=one),
                    port.compress_batch(shards)):
        assert_streams_bit_identical(a, b)
    with pytest.raises(ValueError, match="one process a position"):
        port.compress_batch(shards, plan=two)
    from repro_torch.runtime import fused
    with pytest.raises(ValueError, match="same-shape"):
        fused.batch_compress(_shards("ragged"), 1e-4, 4096, 1024, PORT_OFF,
                             device="cpu")
    with pytest.raises(ValueError, match="one process a position"):
        fused.batch_compress(shards, 1e-4, 4096, 1024, PORT_OFF,
                             device="cpu", plan=two)
    assert port.compress_batch([]) == []
    assert not port.compress_batch([np.zeros(0, np.float32)])[0].chunks
    with pytest.raises(TypeError):
        port.compress_batch([np.ones(8, np.int32)])
