"""The port's sharding plan and meshes (``repro_torch/runtime/sharding.py``,
``repro_torch/launch/mesh.py``) against the reference's, on the CPU.

The reference's specs, plans and ``shard_compress`` streams over real
(2,2), (2,2,2) and (1,2) meshes come from one subprocess with 8 host
devices. The port's meshes here are logical: they name the CPU on every
position, which is all the spec rules read; a mesh that spans one device
runs the batched passes there, and one process cannot drive a mesh over
two devices (ValueError; rank meshes of processes are held in
tests/test_torch_dist.py).
"""
import pickle

import numpy as np
import pytest
import torch

from conftest import assert_streams_bit_identical, run_with_devices
from repro.runtime import sharding as RS
from repro_torch import convert as CV
from repro_torch.core import CEAZ, CEAZConfig
from repro_torch.launch import mesh as LM
from repro_torch.runtime import sharding as S

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "1x2": ((1, 2), ("data", "model"))}
DIMS = (4, 6, 3, 8)         # 3 divides no axis: the guard replicates it
PATHS = [f"layers/0/{pat}" if pat else "misc/leaf"
         for pat, _ in S.PARAM_RULES] + ["params/embed/table",
                                          "layers/3/ln1/scale"]
SHAPES = [DIMS[:n] for n in range(1, 5)] + [(8, 2, 4), (2, 4, 6, 8)]
SHARD_X = np.cumsum(np.random.default_rng(7).standard_normal((5, 64, 64)),
                    axis=2).astype(np.float32)
SHARD_KW = dict(eb_rel=1e-4, chunk_values=4096, block_size=1024)

_REF_CODE = """
import pickle
import numpy as np
from repro.launch.mesh import make_mesh
from repro.runtime import sharding as RS
meshes, paths, shapes, kw = pickle.load(open(IN_PATH, "rb"))
out = {}
for name, (shape, axes) in meshes.items():
    plan = RS.make_plan(make_mesh(shape, axes))
    specs = {}
    for attn in ("heads", "head_dim"):
        plan.attn_part = attn
        for p in paths:
            for s in shapes:
                specs[(attn, p, s)] = tuple(RS.leaf_sharding(p, s, plan).spec)
    plan.attn_part = "heads"
    out[name] = dict(specs=specs, batch_axes=plan.batch_axes,
                     batch=plan.batch, cache=plan.cache_kv_spec(),
                     model_size=plan.model_size)
x = np.asarray(kw["x"])
for name, (shape, axes) in meshes.items():
    plan = RS.make_plan(make_mesh(shape, axes))
    comps, per = RS.shard_compress(x, plan, **kw["args"])
    out[name]["shard"] = (comps, per)
pickle.dump(out, open(OUT_PATH, "wb"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_sharding")
    src, dst = str(d / "in.pkl"), str(d / "out.pkl")
    with open(src, "wb") as f:
        pickle.dump((MESHES, PATHS, SHAPES,
                     {"x": SHARD_X, "args": SHARD_KW}), f)
    run_with_devices(_REF_CODE.replace("IN_PATH", repr(src))
                     .replace("OUT_PATH", repr(dst)), n_devices=8)
    with open(dst, "rb") as f:
        return pickle.load(f)


def _plan(name):
    shape, axes = MESHES[name]
    return S.make_plan(LM.make_mesh(shape, axes,
                                    devices=["cpu"] * int(np.prod(shape))))


@pytest.mark.parametrize("attn", ["heads", "head_dim"])
@pytest.mark.parametrize("ndim", [0, 1, 2, 3, 4])
def test_spec_for_path_matches_reference(attn, ndim):
    for path in PATHS:
        got = S.spec_for_path(path, ndim, attn)
        assert isinstance(got, S.PartitionSpec)
        assert tuple(got) == tuple(RS.spec_for_path(path, ndim, attn)), path


@pytest.mark.parametrize("name", sorted(MESHES))
def test_leaf_sharding_and_plan_match_reference(ref, name):
    plan = _plan(name)
    r = ref[name]
    assert plan.batch_axes == r["batch_axes"] and plan.batch == r["batch"]
    assert plan.cache_kv_spec() == r["cache"]
    assert plan.model_size == r["model_size"]
    for attn in ("heads", "head_dim"):
        plan.attn_part = attn
        for p in PATHS:
            for s in SHAPES:
                sh = S.leaf_sharding(p, s, plan)
                assert sh.mesh is plan.mesh
                assert tuple(sh.spec) == r["specs"][(attn, p, s)], \
                    (attn, p, s)


@pytest.mark.parametrize("name", sorted(MESHES) + ["none"])
def test_shard_compress_matches_reference(ref, name):
    """One shard per position of the batch axes, ragged tail included:
    (2,2) cuts 5 rows as 3+2, (2,2,2) as 2+2+1, (1,2) and no mesh keep
    one shard."""
    plan = S.make_plan(None) if name == "none" else _plan(name)
    comps, per = S.shard_compress(SHARD_X, plan, device="cpu", **SHARD_KW)
    if name == "none":
        rcomps, rper = RS.shard_compress(SHARD_X, RS.make_plan(None),
                                         **SHARD_KW)
    else:
        rcomps, rper = ref[name]["shard"]
    assert per == rper and len(comps) == len(rcomps)
    assert len(comps) == {"2x2": 2, "2x2x2": 3}.get(name, 1)
    for c, r in zip(comps, rcomps):
        assert_streams_bit_identical(c, CV.from_reference(r))


def test_make_plan_and_helpers():
    assert S.make_plan(None).mesh is None
    m = LM.make_mesh((2, 3), ("x", "y"), devices=["cpu"] * 6)
    assert S.make_plan(m).batch_axes == ("x",)       # first axis fallback
    assert m.shape == {"x": 2, "y": 3}
    assert m.device_set == (torch.device("cpu"),)
    for plan in (S.make_plan(None), _plan("2x2")):
        x = torch.ones(2, 3, 4)
        for f in (plan.act_btd, plan.act_btf, plan.logits_btv):
            assert f(x) is x
        assert plan.act_bthd(x[None]).shape == (1, 2, 3, 4)
    p = S.ShardingPlan(decode_wide=True, batch_axes=("pod", "data"))
    assert p.cache_kv_spec() == (None, ("pod", "data", "model"))
    assert p.batch == ("pod", "data") and p.axis_size("data") == 1
    assert S.make_plan(None).named("data") is None
    assert tuple(_plan("2x2").named("data", None).spec) == ("data", None)
    shards = S.param_shardings({"mlp/wi": torch.zeros(4, 6)}, _plan("2x2"))
    assert tuple(shards["mlp/wi"].spec) == (None, "model")
    assert S.param_shardings({"a": np.zeros(3)}, S.make_plan(None)) \
        == {"a": None}


def test_one_device_mesh_runs_and_two_devices_raise():
    rng = np.random.default_rng(3)
    xs = [np.cumsum(rng.standard_normal(5000)).astype(np.float32)
          for _ in range(2)]
    comp = CEAZ(CEAZConfig(device="cpu", block_size=1024))
    base = comp.compress_batch(xs)
    one = S.make_plan(LM.make_mesh((1, 1), ("data", "model"),
                                   devices=["cpu"]))
    for plan in (one, _plan("2x2")):
        for a, b in zip(comp.compress_batch(xs, plan=plan), base):
            assert_streams_bit_identical(a, b)
    leaf = np.arange(12, dtype=np.float32).reshape(3, 4)
    placed = S.place(leaf, S.leaf_sharding("mlp/wo", leaf.shape, one))
    assert isinstance(placed, torch.Tensor) and placed.device.type == "cpu"
    assert placed.numpy().tobytes() == leaf.tobytes()
    assert S.place(leaf, None) is leaf
    two = S.make_plan(LM.make_mesh((2, 1), ("data", "model"),
                                   devices=["cuda:0", "cuda:1"]))
    calls = [lambda: comp.compress_batch(xs, plan=two),
             lambda: S.place(leaf, S.leaf_sharding("mlp/wo", (3, 4), two)),
             lambda: S.shard_compress(leaf, two, device="cpu"),
             lambda: two.act_btd(leaf)]
    for call in calls:
        with pytest.raises(ValueError, match="one process a position"):
            call()
    # the spec rules need no placement: a two-device mesh still answers
    assert tuple(S.leaf_sharding("mlp/wo", (4, 3), two).spec) == \
        ("model", None)


def test_production_mesh_needs_its_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have >= 256:
        pytest.skip("enough cards for the production mesh")
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="need"):
            LM.make_production_mesh(multi_pod=multi)
    m = LM.make_mesh((2, 2), ("data", "model"))
    assert m.device_set == tuple(torch.device("cuda", i) for i in range(4))
    with pytest.raises(ValueError, match="need 4 devices"):
        LM.make_mesh((2, 2), ("data", "model"), devices=["cpu"])
