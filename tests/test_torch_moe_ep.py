"""MoE expert parallelism over a model group of 2 ranks
(``repro_torch/models/modules.py::moe_apply`` on a rank mesh, gloo on
the CPU) against the reference's ``moe_apply`` on a (data=1, model=2)
mesh of host devices, and against the port's one-process
``moe_block_by_shards``; reduced phi3.5-moe and deepseek-v2 (with its
shared expert), B 2 x S 16 tokens.

* Routing, capacity and drops: each rank's expert shard's ``moe_route``
  (top k, pair order, slots, the kept mask) bitwise the reference's
  routing lines of ``moe_local_math`` for that shard. The f32 cases take
  exactly representable inputs, so both sides' router logits are exact
  and equal; "overfull" makes most tokens pick the first two experts,
  whose later tokens drop at the per-shard capacity.
* Outputs and aux: f32 within 4 ulps of the reference's (plus 1e-6
  absolute, for outputs that cancel to near 0); bf16 within the models'
  bound (rtol 0.06, atol 0.05); every rank's output bitwise the
  one-process sum of the shards in rank order.
* Gradients of sum(y c) + aux: against ``jax.grad`` of the reference on
  its 2-device model axis, which equal its one-device gradients
  (unscaled; ROADMAP Queue 3), within 2^-7 relative L2 a leaf in bf16
  and 1e-5 in f32.
* Without a model axis, a data axis of 2 ranks routes the global batch
  as the reference does (its capacity over every row).
* The train step of the reduced archs on a logical (data=2, model=1)
  mesh (one process) against the same step on 2 ranks, each on its
  rows of the global batch: the loss and the aux within 1e-5 in f32,
  the whole gradients within 2^-7 relative L2 a leaf (the bound of the
  port's rank steps against one process: the flash backward rounds its
  blocks to bf16). The ranks route the global batch, so the one process
  takes it whole, not position by position.
* An expert count the model axis does not divide raises.
"""
import pickle

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.configs import get_arch
from repro_torch.data import synthetic as SYN
from repro_torch.launch import mesh as LM
from repro_torch.launch import train as TR
from repro_torch.models import modules as M
from repro_torch.runtime import dist as D
from repro_torch.runtime import sharding as S

ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b")
CASES = [(a, dt, case) for a in ARCHS
         for dt, case in (("f32", "random"), ("f32", "overfull"),
                          ("bf16", "random"))]
B, SEQ = 2, 16
LOGIT_TOL = dict(rtol=0.06, atol=0.05)
GRAD_REL = {"f32": 1e-5, "bf16": 2.0 ** -7}
ROUTE_KEYS = ("top_i", "order", "se", "st", "counts", "pos", "valid")


def _moe_cfg(arch):
    cfg = get_arch(arch).reduced()
    return next(b.moe for u in cfg.units for b in u.blocks
                if b.mlp_kind == "moe")


def _inputs(arch, dt, case):
    """Numpy params and x (exactly representable in the f32 cases: small
    integers over powers of two), and the loss weights c."""
    cfg = _moe_cfg(arch)
    rng = np.random.default_rng(CASES.index((arch, dt, case)))
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    ints = lambda shape, lo, hi, den: (rng.integers(lo, hi + 1, shape)
                                       / den).astype(np.float32)
    p = {"moe": {"router": ints((d, E), -4, 4, 16),
                 "wi": ints((E, d, f), -4, 4, 64),
                 "wg": ints((E, d, f), -4, 4, 64),
                 "wo": ints((E, f, d), -4, 4, 64)}}
    if cfg.n_shared:
        fs = cfg.shared_d_ff or f * cfg.n_shared
        p["shared"] = {"mlp": {"wi": ints((d, fs), -4, 4, 64),
                               "wg": ints((d, fs), -4, 4, 64),
                               "wo": ints((fs, d), -4, 4, 64)}}
    x = ints((B, SEQ, d), -8, 8, 8)
    if case == "overfull":          # a constant feature pulls experts 0, 1
        x[..., 0] = 1.0
        p["moe"]["router"][0, :2] = 4.0
    if dt == "bf16":
        x = rng.standard_normal((B, SEQ, d)).astype(np.float32)
    c = rng.standard_normal((B, SEQ, d)).astype(np.float32)
    return p, x, c


def _torch_dtype(dt):
    return torch.float32 if dt == "f32" else torch.bfloat16


def _tree(p, grad=False):
    return {k: _tree(v, grad) if isinstance(v, dict)
            else torch.from_numpy(v).requires_grad_(grad)
            for k, v in p.items()}


def _leaves(t, prefix=""):
    for k in sorted(t):
        v = t[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


# -- the ranks' side ----------------------------------------------------------------

def ep_ranks(rank):
    """Every case on a (data=1, model=2) rank mesh: y, aux, the gradients
    and this rank's shard's routing."""
    plan = S.make_plan(LM.make_mesh((1, 2), ("data", "model"),
                                    devices=["cpu"] * 2))
    out = {}
    for arch, dt, case in CASES:
        cfg = _moe_cfg(arch)
        p, x, c = _inputs(arch, dt, case)
        pt = _tree(p, grad=True)
        xt = torch.from_numpy(x).to(_torch_dtype(dt)).requires_grad_(True)
        y, aux = M.moe_apply(pt, cfg, xt, plan)
        loss = torch.sum(y.float() * torch.from_numpy(c)) + aux
        leaves = dict(_leaves(pt))
        got = torch.autograd.grad(loss, [xt] + list(leaves.values()))
        nl = cfg.n_experts // 2
        cap = M._moe_capacity(B * SEQ, cfg, nl)
        with torch.no_grad():
            _, _, r = M.moe_local_math(
                xt.reshape(B * SEQ, -1), M._expert_slice(
                    pt["moe"], rank * nl, nl), cfg, rank * nl, nl, cap,
                with_route=True)
        out[(arch, dt, case)] = {
            "y": y.detach(), "aux": float(aux), "cap": cap,
            "grads": {"x": got[0], **dict(zip(leaves, got[1:]))},
            "route": {k: r[k].clone() for k in ROUTE_KEYS}}
    three = M.MoEConfig(d_model=8, d_ff=8, n_experts=3, top_k=2)
    try:
        M.moe_apply({"moe": {"router": torch.zeros(8, 3)}}, three,
                    torch.zeros(1, 2, 8), plan)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def dp_ranks(rank):
    """The f32 cases on a (data=2, model=1) rank mesh, each rank one row of
    the batch: y and aux, and the gradients of sum(y c) over its row."""
    plan = S.make_plan(LM.make_mesh((2, 1), ("data", "model"),
                                    devices=["cpu"] * 2))
    out = {}
    for arch, dt, case in CASES:
        if dt != "f32":
            continue
        cfg = _moe_cfg(arch)
        p, x, c = _inputs(arch, dt, case)
        pt = _tree(p, grad=True)
        xt = torch.from_numpy(x[rank:rank + 1]).requires_grad_(True)
        y, aux = M.moe_apply(pt, cfg, xt, plan)
        loss = torch.sum(y * torch.from_numpy(c[rank:rank + 1]))
        leaves = dict(_leaves(pt))
        got = torch.autograd.grad(loss, [xt] + list(leaves.values()))
        out[(arch, dt, case)] = {"y": y.detach(), "aux": float(aux),
                                 "grads": {"x": got[0],
                                           **dict(zip(leaves, got[1:]))}}
    return out


def _train_data(cfg):
    return SYN.DataConfig(vocab_size=cfg.vocab_size, global_batch=4,
                          seq_len=32)


def _train_step(cfg, plan, batch):
    """One f32 train step from seed 0 -> (loss, aux, whole gradients)."""
    old, M.COMPUTE_DTYPE = M.COMPUTE_DTYPE, torch.float32
    try:
        state = TR.init_state(0, cfg, TR.TrainConfig(), plan, device="cpu")
        step = TR.make_train_step(cfg, TR.TrainConfig(), plan, device="cpu",
                                  keep_grads=True)
        _, m = step(state, TR.batch_on(batch, "cpu"))
    finally:
        M.COMPUTE_DTYPE = old
    return float(m["loss"]), float(m["aux"]), m["grads"]


def train_dp_ranks(rank):
    """The reduced archs' train step on a (data=2, model=1) rank mesh,
    each rank on its rows of the global batch."""
    out = {}
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        plan = TR.make_plan_for(cfg, LM.make_mesh(
            (2, 1), ("data", "model"), devices=["cpu"] * 2))
        rows = SYN.batch_rows(SYN.batch_for_step(_train_data(cfg), 0),
                              *plan.batch_index())
        out[arch] = _train_step(cfg, plan, rows)
    return out


# -- the reference's side -----------------------------------------------------------

_REF = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch
from repro.launch.mesh import make_mesh
from repro.models import modules as RM
from repro.runtime.sharding import make_plan
cases = pickle.load(open(IN_PATH, 'rb'))
plan = make_plan(make_mesh((1, 2), ('data', 'model')))
def route(gates, k, E, first, n_local, capacity):
    T = gates.shape[0]
    top_w, top_i = jax.lax.top_k(gates, k)
    flat_e = top_i.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(T), k)
    order = jnp.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    counts = jnp.bincount(se, length=E)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(T * k) - starts[se]
    e_loc = se - first
    valid = (e_loc >= 0) & (e_loc < n_local) & (pos < capacity)
    return dict(top_i=top_i, order=order, se=se, st=st, counts=counts,
                pos=pos, valid=valid)
out = {}
for key, (arch, dt, p, x, c) in cases.items():
    cfg = next(b.moe for u in get_arch(arch).reduced().units
               for b in u.blocks if b.mlp_kind == 'moe')
    dtype = jnp.float32 if dt == 'f32' else jnp.bfloat16
    p = jax.tree.map(jnp.asarray, p)
    xj = jnp.asarray(x, dtype)
    def loss(p, xj):
        y, aux = RM.moe_apply(p, cfg, xj, plan)
        return jnp.sum(y.astype(jnp.float32) * c) + aux, (y, aux)
    (l, (y, aux)), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, xj)
    nl = cfg.n_experts // 2
    T = x.shape[0] * x.shape[1]
    cap = RM._moe_capacity(T, cfg, nl)
    x2d = xj.reshape(T, -1)
    logits = jnp.einsum('td,de->te', x2d, p['moe']['router'].astype(dtype))
    gates = jax.nn.softmax(logits.astype(jnp.float32), -1)
    routes = [jax.tree.map(np.asarray, route(gates, cfg.top_k,
                                             cfg.n_experts, m * nl, nl, cap))
              for m in range(2)]
    flat = {'x': np.asarray(g[1], np.float32)}
    for path, v in jax.tree_util.tree_flatten_with_path(g[0])[0]:
        flat['/'.join(k.key for k in path)] = np.asarray(v)
    out[key] = dict(y=np.asarray(y.astype(jnp.float32)), aux=float(aux),
                    grads=flat, routes=routes, cap=cap)
    if dt == 'f32':             # a data axis of 2: the global batch routed
        dplan = make_plan(make_mesh((2, 1), ('data', 'model')))
        def dloss(p, xj):
            y, aux = RM.moe_apply(p, cfg, xj, dplan)
            return jnp.sum(y.astype(jnp.float32) * c), (y, aux)
        (_, (y, aux)), g = jax.jit(jax.value_and_grad(
            dloss, argnums=(0, 1), has_aux=True))(p, xj)
        flat = {'x': np.asarray(g[1], np.float32)}
        for path, v in jax.tree_util.tree_flatten_with_path(g[0])[0]:
            flat['/'.join(k.key for k in path)] = np.asarray(v)
        out[key]['dp'] = dict(y=np.asarray(y), aux=float(aux), grads=flat)
pickle.dump(out, open(OUT_PATH, 'wb'))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_ep")
    src, dst = str(d / "in.pkl"), str(d / "out.pkl")
    with open(src, "wb") as f:
        pickle.dump({k: (k[0], k[1], *_inputs(*k)) for k in CASES}, f)
    run_with_devices(_REF.replace("IN_PATH", repr(src))
                     .replace("OUT_PATH", repr(dst)), n_devices=2)
    with open(dst, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks():
    return [r.result for r in D.launch(ep_ranks, 2, timeout=180,
                                       threads=1)]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("key", [k for k in CASES if k[1] == "f32"],
                         ids=lambda k: "-".join(k))
def test_routing_and_drops_bitwise(reference, ranks, key):
    ref = reference[key]
    drops = 0
    for m, r in enumerate(ranks):
        got = r[key]
        assert got["cap"] == ref["cap"]
        for k in ROUTE_KEYS:
            want = ref["routes"][m][k]
            assert np.array_equal(got["route"][k].numpy().astype(
                want.dtype), want), (m, k)
        pos, valid = got["route"]["pos"], got["route"]["valid"]
        drops += int(((pos >= got["cap"]) & ~valid).sum())
    if key[2] == "overfull":
        assert drops > 0                    # the capacity binds


@pytest.mark.parametrize("key", CASES, ids=lambda k: "-".join(k))
def test_outputs_match_reference_and_one_process(reference, ranks, key):
    ref = reference[key]
    p, x, _ = _inputs(*key)
    cfg = _moe_cfg(key[0])
    xt = torch.from_numpy(x).to(_torch_dtype(key[1]))
    pt = _tree(p)
    y1, aux1, routes = M.moe_block_by_shards(
        xt.reshape(B * SEQ, -1), pt["moe"], cfg, 2, ref["cap"],
        with_routes=True)
    y1 = y1.reshape(xt.shape)
    if "shared" in pt:
        y1 = y1 + M.mlp_apply({"mlp": pt["shared"]["mlp"]}, xt,
                              S.ShardingPlan(mesh=None), act=cfg.act)
    for m, r in enumerate(ranks):
        got = r[key]
        assert torch.equal(got["y"], y1), m
        assert got["aux"] == float(aux1)
        for k in ROUTE_KEYS:
            assert torch.equal(got["route"][k], routes[m][k]), (m, k)
        y = got["y"].float().numpy()
        if key[1] == "f32":
            tol = 4 * np.spacing(np.abs(ref["y"])) + 1e-6
            assert np.all(np.abs(y - ref["y"]) <= tol), \
                float(np.max(np.abs(y - ref["y"]) - tol))
            assert abs(got["aux"] - ref["aux"]) <= 4 * np.spacing(
                np.float32(abs(ref["aux"])))
        else:
            np.testing.assert_allclose(y, ref["y"], **LOGIT_TOL)
            np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-2)


@pytest.mark.parametrize("key", CASES, ids=lambda k: "-".join(k))
def test_gradients_match_reference(reference, ranks, key):
    ref = reference[key]["grads"]
    for r in ranks:
        got = r[key]["grads"]
        assert sorted(got) == sorted(ref)
        worst = max((_rel_l2(got[k].float().numpy(), ref[k]), k)
                    for k in ref)
        assert worst[0] <= GRAD_REL[key[1]], worst
        for k, g in got.items():            # alike on every model rank
            assert torch.equal(g, ranks[0][key]["grads"][k]), k


@pytest.fixture(scope="module")
def dp():
    return [r.result for r in D.launch(dp_ranks, 2, timeout=180, threads=1)]


@pytest.mark.parametrize("key", [k for k in CASES if k[1] == "f32"],
                         ids=lambda k: "-".join(k))
def test_data_axis_routes_the_global_batch(reference, dp, key):
    """Without a model axis the reference routes the whole batch at once
    (its capacity over every row): each rank gathers the rows of its
    batch group, routes them all and keeps its own (``gather_rows``,
    whose backward sums the rows' cotangents over the group). Each
    rank's output rows and the aux within 4 ulps of the reference's on a
    (data=2, model=1) mesh; the x gradient's rows and the sum of the
    ranks' parameter gradients against ``jax.grad`` there within 1e-5."""
    ref = reference[key]["dp"]
    for r, got in enumerate(dp):
        y, want = got[key]["y"].numpy(), ref["y"][r:r + 1]
        assert np.all(np.abs(y - want) <= 4 * np.spacing(np.abs(want))
                      + 1e-6)
        assert abs(got[key]["aux"] - ref["aux"]) <= 4 * np.spacing(
            np.float32(abs(ref["aux"])))
        assert _rel_l2(got[key]["grads"]["x"].numpy(),
                       ref["grads"]["x"][r:r + 1]) <= GRAD_REL["f32"]
    for k in ref["grads"]:
        if k == "x":
            continue
        total = dp[0][key]["grads"][k] + dp[1][key]["grads"][k]
        assert _rel_l2(total.numpy(), ref["grads"][k]) <= GRAD_REL["f32"], k


@pytest.fixture(scope="module")
def train_dp():
    return [r.result for r in D.launch(train_dp_ranks, 2, timeout=180,
                                       threads=1)]


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_data_mesh_trains_as_the_ranks(train_dp, arch):
    """A logical (data=2, model=1) mesh's step routes the global batch
    at once, as its ranks do: per-position routing would take each
    position's capacity and aux."""
    cfg = get_arch(arch).reduced()
    plan = TR.make_plan_for(cfg, LM.make_mesh((2, 1), ("data", "model"),
                                              devices=["cpu"] * 2))
    loss, aux, grads = _train_step(
        cfg, plan, SYN.batch_for_step(_train_data(cfg), 0))
    for got in train_dp:
        r_loss, r_aux, r_grads = got[arch]
        assert abs(r_loss - loss) <= GRAD_REL["f32"] * abs(loss)
        assert abs(r_aux - aux) <= GRAD_REL["f32"] * abs(aux)
        assert sorted(r_grads) == sorted(grads)
        worst = max((_rel_l2(r_grads[k], grads[k]), k) for k in grads)
        assert worst[0] <= GRAD_REL["bf16"], worst


def test_indivisible_expert_count_raises(ranks):
    for r in ranks:
        assert "experts must divide model axis" in r["indivisible"]
