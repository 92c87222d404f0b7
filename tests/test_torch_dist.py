"""Training over several processes (``repro_torch/runtime/dist.py``,
``launch/mesh.py`` rank meshes, ``runtime/sharding.py`` placement,
``launch/train.py``, ``checkpoint/ckpt.py``) in gloo worlds on the CPU,
against the reference's multi-device tests (``tests/test_distributed.py``)
run once through ``conftest.run_with_devices`` (forced host devices), and
against the port's own one-process runs.

* Data and model axes: glm4-9b reduced, global batch 4 x 32 tokens, 3
  steps on a (data=2, model=2) world of 4: the losses against the
  reference's single-device and 2x2 losses within its 5e-2; step 0's
  gradients against the port's one-process step within 2^-7 relative L2
  a leaf; every rank's shards after init bitwise the slices of the
  one-process leaves, and after every step the slices of the leaves that
  ``gather_leaf`` returns, alike on every rank.
* The pod exchange inside the step: (pod=2, data=1, model=2), 8 bits, 4
  steps, global batch 8: every step's params bitwise the port's
  one-process emulation on a logical mesh (each pod's gradients on its
  rows, ``compressed_cross_pod_mean(group=None)``, AdamW), with and
  without compression; the compressed losses within the reference
  test's 0.05 of the uncompressed. The reference's own case fails on
  this box (ROADMAP Queue 3), so the step is held through the
  emulation, whose exchange ``tests/test_torch_grad_compress.py`` holds
  bitwise against the reference's.
* Elastic restore: the (data=2, model=2) init state saved by rank 0 in
  mode 'raw' and in the default lossy mode, restored onto a world of 2
  on (data=1, model=2): every leaf gathered bitwise the one-process
  restore, the model axis of size 2.
* ``shard_compress``, ``fused.batch_compress`` and ``CEAZ.compress_batch``
  over a 2-rank plan: every field of every stream, on every rank,
  bitwise the reference's with a 2-device plan (ragged and even splits).
* A world whose size does not match the mesh raises.
"""
import pickle

import numpy as np
import pytest
import torch

from conftest import assert_streams_bit_identical, run_with_devices
from repro_torch import convert as CV
from repro_torch.checkpoint import ckpt as C
from repro_torch.configs import get_arch
from repro_torch.data import synthetic as SYN
from repro_torch.launch import mesh as LM
from repro_torch.launch import train as TR
from repro_torch.runtime import dist as D
from repro_torch.runtime import sharding as S

ARCH = "glm4-9b"
LOSS_TOL = 5e-2                  # tests/test_distributed.py's
COMP_TOL = 0.05                  # its pod-exchange case's
GRAD_REL = 2.0 ** -7
SHARD_KW = dict(eb_rel=1e-4, chunk_values=4096, block_size=1024)
SHARD_X = {"ragged": np.cumsum(np.random.default_rng(7).standard_normal(
    (5, 64, 64)), axis=2).astype(np.float32),
           "even": np.cumsum(np.random.default_rng(8).standard_normal(
               (4, 64, 64)), axis=2).astype(np.float32)}
BATCH_SHARDS = [np.cumsum(np.random.default_rng(9 + i).standard_normal(
    (40, 150)), axis=1).astype(np.float32) * 1e-2 for i in range(3)]
TIMEOUT = 240


def _cfg():
    return get_arch(ARCH).reduced()


def _data(batch):
    return SYN.DataConfig(vocab_size=_cfg().vocab_size, global_batch=batch,
                          seq_len=32)


def _host(tree):
    return {k: v.detach().cpu().clone() for k, v in CV.tree_items(tree)}


def _rank_mesh(shape, axes):
    return LM.make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


# -- the ranks' side (run in gloo worlds by runtime/dist.py::launch) -------------

def train_ranks(rank, shape, axes, batch, steps, comps, ckpt_dir,
                params0=None):
    """Train the reduced arch on a rank mesh from seed 0 (from the whole
    leaves `params0` when given, each rank placing its shards) for each
    compression setting in `comps` (None: the default config); ->
    {comp: {"init": shards, "init_whole", "losses", "grads0", "shards",
    "whole"}} and, with `ckpt_dir`, the init state saved raw and lossy."""
    cfg = _cfg()
    plan = TR.make_plan_for(cfg, _rank_mesh(shape, axes))
    out = {}
    for comp in comps:
        tc = TR.TrainConfig() if comp is None else TR.TrainConfig(
            comp=TR.CompressionConfig(bits=8, enabled=comp))
        state = TR.init_state(0, cfg, tc, plan, device="cpu")
        shd = S.param_shardings(state["params"], plan,
                                shapes=TR.param_shapes(cfg))
        rec = {"init": _host(state["params"]),
               "init_whole": {k: S.gather_leaf(v, shd[k]).clone()
                              for k, v in CV.tree_items(state["params"])},
               "losses": [], "shards": [], "whole": []}
        if params0 is not None:
            state["params"] = CV.map_tree(lambda k, _v: S.place(
                torch.from_numpy(params0[k]), shd[k]), state["params"])
        if ckpt_dir and comp is None:
            for mode in ("raw", "ceaz"):
                C.save_checkpoint(f"{ckpt_dir}/{mode}", state, step=1,
                                  cfg=C.CheckpointConfig(mode=mode),
                                  device="cpu", plan=plan,
                                  shapes=TR.state_shapes(cfg, state))
        step = TR.make_train_step(cfg, tc, plan, device="cpu",
                                  keep_grads=True)
        for i in range(steps):
            rows = SYN.batch_rows(SYN.batch_for_step(_data(batch), i),
                                  *plan.batch_index())
            state, m = step(state, TR.batch_on(rows, "cpu"))
            rec["losses"].append(float(m["loss"]))
            if i == 0:
                rec["grads0"] = {k: v.clone() for k, v in m["grads"].items()}
            rec["shards"].append(_host(state["params"]))
            rec["whole"].append({k: S.gather_leaf(v, shd[k]).clone()
                                 for k, v in CV.tree_items(state["params"])})
        out[comp] = rec
    return {"coords": plan.mesh.coords, "out": out}


def restore_ranks(rank, ckpt_dir):
    """Restore both saved states onto (data=1, model=2): each rank's
    leaves gathered, the model axis's size and the shard shapes."""
    cfg = _cfg()
    plan = TR.make_plan_for(cfg, _rank_mesh((1, 2), ("data", "model")))
    out = {"model": plan.mesh.shape["model"]}
    for mode in ("raw", "ceaz"):
        state, meta = C.restore_checkpoint(
            f"{ckpt_dir}/{mode}", plan=plan,
            cfg=C.CheckpointConfig(mode=mode), device="cpu")
        shd = S.param_shardings(state, plan,
                                shapes=TR.state_shapes(cfg, state))
        out[mode] = {k: S.gather_leaf(v, shd[k]).clone()
                     for k, v in CV.tree_items(state)}
        out[mode + "_shapes"] = {k: tuple(v.shape)
                                 for k, v in CV.tree_items(state)}
        out[mode + "_step"] = meta["step"]
    return out


def compress_ranks(rank):
    """shard_compress (ragged and even), fused.batch_compress and
    CEAZ.compress_batch over a 2-rank plan on the data axis."""
    from repro_torch.core import CEAZ, CEAZConfig
    from repro_torch.core.codebook import default_offline_codebook
    from repro_torch.runtime import fused
    plan = S.make_plan(_rank_mesh((2,), ("data",)))
    out = {k: S.shard_compress(x, plan, device="cpu", **SHARD_KW)
           for k, x in SHARD_X.items()}
    out["facade"] = CEAZ(CEAZConfig(device="cpu", use_fused=True)) \
        .compress_batch(BATCH_SHARDS, plan=plan)
    out["fused"] = fused.batch_compress(
        BATCH_SHARDS, 1e-4, 4096, 1024, default_offline_codebook(),
        device="cpu", plan=plan)
    try:
        LM.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


# -- the reference's side ---------------------------------------------------------

_REF_TRAIN = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro_torch.convert import tree_items
from repro.configs import get_arch
from repro.launch import mesh as M
from repro.launch.train import (TrainConfig, init_state, jit_train_step,
                                make_plan_for)
from repro.data.synthetic import DataConfig, batch_for_step
from repro.runtime.sharding import ShardingPlan
cfg = get_arch('glm4-9b').reduced()
dc = DataConfig(vocab_size=cfg.vocab_size, global_batch=4, seq_len=32)
tc = TrainConfig()
losses = {}
for name, mesh in (('single', None),
                   ('2x2', M.make_mesh((2, 2), ('data', 'model')))):
    plan = (make_plan_for(cfg, mesh) if mesh is not None
            else ShardingPlan(mesh=None))
    state = init_state(jax.random.key(0), cfg, tc, plan)
    losses['params'] = {k: np.asarray(v)
                        for k, v in tree_items(state['params'])}
    b = {k: jnp.asarray(v) for k, v in batch_for_step(dc, 0).items()}
    fn = jit_train_step(cfg, tc, plan, state, b)
    ls = []
    for i in range(3):
        b = {k: jnp.asarray(v) for k, v in batch_for_step(dc, i).items()}
        state, m = fn(state, b)
        ls.append(float(m['loss']))
    losses[name] = ls
pickle.dump(losses, open(OUT_PATH, 'wb'))
"""

_REF_SHARD = """
import pickle
import numpy as np
from repro.core import CEAZ, CEAZConfig
from repro.core.codebook import default_offline_codebook
from repro.launch.mesh import make_mesh
from repro.runtime import fused
from repro.runtime import sharding as RS
xs, kw, shards = pickle.load(open(IN_PATH, 'rb'))
plan = RS.make_plan(make_mesh((2,), ('data',)))
out = {k: RS.shard_compress(x, plan, **kw) for k, x in xs.items()}
out['facade'] = CEAZ(CEAZConfig(use_fused=True)).compress_batch(
    shards, plan=plan)
out['fused'] = fused.batch_compress(shards, 1e-4, 4096, 1024,
                                    default_offline_codebook(), plan=plan)
pickle.dump(out, open(OUT_PATH, 'wb'))
"""


def _reference(tmp_path_factory, code, inputs=None):
    d = tmp_path_factory.mktemp("ref_dist")
    src, dst = str(d / "in.pkl"), str(d / "out.pkl")
    with open(src, "wb") as f:
        pickle.dump(inputs, f)
    run_with_devices(code.replace("IN_PATH", repr(src))
                     .replace("OUT_PATH", repr(dst)), n_devices=4)
    with open(dst, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ref_losses(tmp_path_factory):
    return _reference(tmp_path_factory, _REF_TRAIN)


@pytest.fixture(scope="module")
def ref_shards(tmp_path_factory):
    return _reference(tmp_path_factory, _REF_SHARD,
                      (SHARD_X, SHARD_KW, BATCH_SHARDS))


# -- the port's runs ---------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process(ref_losses):
    """The port's one-process run of the (data=2, model=2) case: its init
    leaves (seed 0), then losses and step 0's gradients from the
    reference's init."""
    cfg = _cfg()
    plan = S.ShardingPlan(mesh=None)
    state = TR.init_state(0, cfg, TR.TrainConfig(), plan, device="cpu")
    init = _host(state["params"])
    state["params"] = CV.map_tree(lambda k, _v: torch.from_numpy(
        ref_losses["params"][k]), state["params"])
    step = TR.make_train_step(cfg, TR.TrainConfig(), plan, device="cpu",
                              keep_grads=True)
    losses = []
    for i in range(3):
        batch = TR.batch_on(SYN.batch_for_step(_data(4), i), "cpu")
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            grads0 = m["grads"]
    return init, losses, grads0


@pytest.fixture(scope="module")
def dp_tp(tmp_path_factory, ref_losses):
    """The (data=2, model=2) world: 3 steps from the reference's init, the
    init state saved."""
    d = tmp_path_factory.mktemp("dist_ckpt")
    res = D.launch(train_ranks, 4, args=((2, 2), ("data", "model"), 4, 3,
                                         (None,), str(d),
                                         ref_losses["params"]),
                   timeout=TIMEOUT, threads=1)
    return [r.result for r in res], str(d)


@pytest.fixture(scope="module")
def pods():
    """The (pod=2, data=1, model=2) world, without and with the
    compressed exchange, and the one-process emulation of each."""
    res = D.launch(train_ranks, 4, args=((2, 1, 2), ("pod", "data", "model"),
                                         8, 4, (False, True), None),
                   timeout=TIMEOUT, threads=1)
    cfg = _cfg()
    plan = TR.make_plan_for(cfg, LM.make_mesh(
        (2, 1, 2), ("pod", "data", "model"), devices=["cpu"] * 4))
    emul = {}
    for comp in (False, True):
        tc = TR.TrainConfig(comp=TR.CompressionConfig(bits=8, enabled=comp))
        state = TR.init_state(0, cfg, tc, plan, device="cpu")
        step = TR.make_train_step(cfg, tc, plan, device="cpu")
        got = []
        for i in range(4):
            batch = TR.batch_on(SYN.batch_for_step(_data(8), i), "cpu")
            state, m = step(state, batch)
            got.append((float(m["loss"]), _host(state["params"])))
        emul[comp] = got
    return [r.result for r in res], emul


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-30))


def _shard_of(whole, key, shape, axes, coords):
    """The block of `whole` the mesh position `coords` holds."""
    plan = TR.make_plan_for(_cfg(), LM.make_mesh(
        shape, axes, devices=["cpu"] * int(np.prod(shape))))
    sh = S.leaf_sharding(key, tuple(whole.shape), plan)
    return whole[S.shard_slices(whole.shape, sh, coords)]


# -- data and model axes -----------------------------------------------------------

def test_tp_dp_losses_match_reference(ref_losses, dp_tp, one_process):
    ranks, _ = dp_tp
    ref = ref_losses
    for r in ranks:
        got = r["out"][None]["losses"]
        for want in (ref["single"], ref["2x2"], one_process[1]):
            assert all(abs(x - y) < LOSS_TOL for x, y in zip(got, want)), \
                (got, want)
    assert len({tuple(r["out"][None]["losses"]) for r in ranks}) == 1


def test_tp_dp_grads_match_one_process(dp_tp, one_process):
    ranks, _ = dp_tp
    want = one_process[2]
    for r in ranks:
        got = r["out"][None]["grads0"]
        assert sorted(got) == sorted(want)
        worst = max((_rel_l2(got[k], want[k]), k) for k in want)
        assert worst[0] <= GRAD_REL, worst
        # every rank took the same whole gradients
        for k, g in got.items():
            assert torch.equal(g, ranks[0]["out"][None]["grads0"][k]), k


def test_tp_dp_shards_are_slices(dp_tp, one_process):
    ranks, _ = dp_tp
    init = one_process[0]
    sharded = 0
    for r in ranks:
        rec = r["out"][None]
        for k, whole in init.items():
            want = _shard_of(whole, k, (2, 2), ("data", "model"),
                             r["coords"])
            assert torch.equal(rec["init"][k], want), k
            assert torch.equal(rec["init_whole"][k], whole), k
            sharded += rec["init"][k].shape != whole.shape
        for i, (shards, whole) in enumerate(zip(rec["shards"],
                                                rec["whole"])):
            for k, w in whole.items():
                assert torch.equal(shards[k], _shard_of(
                    w, k, (2, 2), ("data", "model"), r["coords"])), (i, k)
                assert torch.equal(
                    w, ranks[0]["out"][None]["whole"][i][k]), (i, k)
    assert sharded > 0               # the model axis splits some leaves


# -- the pod exchange inside the step ----------------------------------------------

@pytest.mark.parametrize("comp", [False, True], ids=["plain", "compressed"])
def test_pod_exchange_matches_emulation_bitwise(pods, comp):
    ranks, emul = pods
    for r in ranks:
        rec = r["out"][comp]
        for i, (loss, params) in enumerate(emul[comp]):
            assert rec["losses"][i] == loss, (i, rec["losses"][i], loss)
            for k, w in params.items():
                assert torch.equal(rec["whole"][i][k], w), (i, k)
                assert torch.equal(rec["shards"][i][k], _shard_of(
                    w, k, (2, 1, 2), ("pod", "data", "model"),
                    r["coords"])), (i, k)


def test_compressed_exchange_tracks_uncompressed(pods):
    ranks, emul = pods
    base = ranks[0]["out"][False]["losses"]
    comp = ranks[0]["out"][True]["losses"]
    assert all(abs(x - y) < COMP_TOL for x, y in zip(base, comp)), \
        (base, comp)
    # the exchange moved the params off the uncompressed ones
    k = "units/0/b0/attn/wq"
    assert not torch.equal(ranks[0]["out"][True]["whole"][-1][k],
                           ranks[0]["out"][False]["whole"][-1][k])


# -- elastic restore ---------------------------------------------------------------

@pytest.fixture(scope="module")
def restored(dp_tp):
    _, ckpt = dp_tp
    res = D.launch(restore_ranks, 2, args=(ckpt,), timeout=TIMEOUT,
                   threads=1)
    return [r.result for r in res], ckpt


@pytest.mark.parametrize("mode", ["raw", "ceaz"])
def test_elastic_restore_across_meshes(restored, ref_losses, mode):
    ranks, ckpt = restored
    want, meta = C.restore_checkpoint(f"{ckpt}/{mode}",
                                      cfg=C.CheckpointConfig(mode=mode),
                                      device="cpu")
    want = dict(CV.tree_items(want))
    assert meta["step"] == 1
    for r in ranks:
        assert r["model"] == 2 and r[mode + "_step"] == 1
        got = r[mode]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = torch.as_tensor(np.asarray(w)) if not isinstance(
                w, torch.Tensor) else w
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    # the raw save holds the saved (the reference's init) params bitwise
    for k, w in ref_losses["params"].items():
        assert torch.equal(ranks[0]["raw"]["params/" + k],
                           torch.from_numpy(w)), k
    # the model axis split the restored shards
    assert ranks[0]["raw_shapes"]["params/embed/table"][0] * 2 == \
        ranks[0]["raw"]["params/embed/table"].shape[0]


# -- shard_compress and the batch over a 2-rank plan --------------------------------

@pytest.fixture(scope="module")
def compressed():
    return [r.result for r in D.launch(compress_ranks, 2, timeout=TIMEOUT,
                                       threads=1)]


@pytest.mark.parametrize("split", ["ragged", "even"])
def test_shard_compress_matches_reference(ref_shards, compressed, split):
    rcomps, rper = ref_shards[split]
    for r in compressed:
        comps, per = r[split]
        assert per == rper and len(comps) == len(rcomps) == 2
        for c, rc in zip(comps, rcomps):
            assert_streams_bit_identical(c, CV.from_reference(rc))


@pytest.mark.parametrize("route", ["facade", "fused"])
def test_batch_over_ranks_matches_reference(ref_shards, compressed, route):
    for r in compressed:
        assert len(r[route]) == len(ref_shards[route]) == 3
        for c, rc in zip(r[route], ref_shards[route]):
            assert_streams_bit_identical(c, CV.from_reference(rc))


def test_world_size_must_match_the_mesh(compressed):
    for r in compressed:
        assert r["mismatch"] is not None and "world of 2" in r["mismatch"]


def test_state_shardings_follow_param_rules():
    """The reference's ``state_shardings``: the moments and the residual
    placed as the params, the step replicated; from a rank's shards with
    the whole shapes, the same specs."""
    cfg = _cfg()
    plan = TR.make_plan_for(cfg, LM.make_mesh(
        (2, 1, 2), ("pod", "data", "model"), devices=["cpu"] * 4))
    tc = TR.TrainConfig(comp=TR.CompressionConfig(enabled=True))
    state = TR.init_state(0, cfg, tc, plan, device="cpu")
    sh = TR.state_shardings(state, plan)
    want = S.param_shardings(state["params"], plan)
    for part in (sh["params"], sh["opt"]["mu"], sh["opt"]["nu"]):
        assert {k: v.spec for k, v in part.items()} == \
            {k: v.spec for k, v in want.items()}
    assert tuple(sh["opt"]["step"].spec) == ()
    assert sorted(sh["residual"]) == sorted(want)
    assert tuple(want["embed/table"].spec) == ("model", None)
    shapes = TR.param_shapes(cfg)
    halves = {k: torch.zeros(v.shape[0] // 2, *v.shape[1:])
              if tuple(want[k].spec[:1]) == ("model",) else v
              for k, v in CV.tree_items(state["params"])}
    got = S.param_shardings(halves, plan, shapes=shapes)
    assert {k: v.spec for k, v in got.items()} == \
        {k: v.spec for k, v in want.items()}


def test_launch_reports_a_failing_child():
    with pytest.raises(D.ChildFailed, match="this rank fails") as e:
        D.launch(failing_rank, 2, timeout=60, threads=1)
    assert "ranks [" in str(e.value) and "1]" in str(e.value)


def failing_rank(rank):
    if rank == 1:
        raise RuntimeError("this rank fails")
    return rank
