"""The port's MoE and MLA blocks (``repro_torch/models/modules.py``) against
the reference's, on the CPU, both packages fed the same numpy inputs.

* ``_moe_capacity`` over a grid, exactly.
* Routing given the same gates, bitwise: ``moe_route`` against the
  reference's routing lines (``models/modules.py:624-639``, run below as
  jnp: ``jax.lax.top_k``, the stable argsort, ``bincount``, the slot
  positions and the drop mask), with exact ties among the gates and
  overfull experts whose later tokens drop. XLA on the CPU sums the k
  weights and scatter-adds the pairs in their order (checked here): the
  port does the same in explicit loops, so both are bitwise.
* ``moe_local_math`` in f32 with exactly representable inputs (every
  product and sum exact, so ties are ties on both sides) against the
  reference's, on all experts and on a shard of them; ``moe_apply`` in
  bf16 with and without shared experts within the models' bound (rtol
  0.06, atol 0.05).
* ``mla_apply`` and ``mla_decode`` on f32 inputs within the reference's
  flash-against-naive bound (rtol 3e-2, atol 8e-3); the latent cache
  writes within 4 f32 ulps.
* The port's teacher-forced MLA decode against its own prefill on an
  MLA config with dense MLPs (no capacity binds), and the parameter
  rules' specs for every MoE and MLA leaf against the reference's.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.configs import get_arch as ref_arch
from repro.models import modules as RM
from repro.models import transformer as RT
from repro.runtime.sharding import ShardingPlan as RPlan
from repro_torch import convert as CV
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as LM
from repro_torch.models import modules as M
from repro_torch.models import transformer as T
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.sharding import ShardingPlan

RPLAN, PLAN = RPlan(mesh=None), ShardingPlan(mesh=None)
LOGIT_TOL = dict(rtol=0.06, atol=0.05)
FLASH_TOL = dict(rtol=3e-2, atol=8e-3)
F32_TOL = dict(rtol=5e-7, atol=1e-6)
MOE_ARCHS = ("deepseek-v2-236b", "phi3.5-moe-42b-a6.6b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- capacity and routing --------------------------------------------------------

@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (16, 2), (160, 6)])
@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0])
def test_moe_capacity_matches_reference(E, k, cf):
    kw = dict(d_model=8, d_ff=8, n_experts=E, top_k=k, capacity_factor=cf)
    rcfg, cfg = RM.MoEConfig(**kw), M.MoEConfig(**kw)
    for tokens in (1, 2, 7, 8, 40, 64, 100, 512, 1000, 4096, 65536):
        assert M._moe_capacity(tokens, cfg, E) == \
            RM._moe_capacity(tokens, rcfg, E), tokens


def _ref_route(gates, top_k, n_experts, first, n_local, capacity):
    """The reference's routing, lines 626-637 of its moe_local_math."""
    T = gates.shape[0]
    top_w, top_i = jax.lax.top_k(gates, top_k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    flat_e = top_i.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(T), top_k)
    flat_w = top_w.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = jnp.bincount(se, length=n_experts)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(T * top_k) - starts[se]
    e_loc = se - first
    valid = (e_loc >= 0) & (e_loc < n_local) & (pos < capacity)
    return dict(top_i=top_i, top_w=top_w, order=order, se=se, st=st, sw=sw,
                counts=counts, pos=pos, valid=valid)


def _gates(case, T, E, rng):
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if case == "ties":          # a few values per row: many exact ties
        logits = rng.integers(0, 3, (T, E)).astype(np.float32)
    elif case == "overfull":    # most tokens want experts 0 and 1
        logits[:, :2] += 6.0
    elif case == "uniform":     # every gate equal
        logits[:] = 0.5
    g = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    return np.ascontiguousarray(g, np.float32)


@pytest.mark.parametrize("case", ["random", "ties", "overfull", "uniform"])
@pytest.mark.parametrize("T,E,k,first,n_local", [
    (40, 4, 2, 0, 4), (40, 8, 2, 0, 8), (512, 160, 6, 0, 160),
    (96, 16, 2, 4, 8), (7, 160, 6, 40, 40)])
def test_moe_route_matches_reference_bitwise(rng, case, T, E, k, first,
                                             n_local):
    g = _gates(case, T, E, rng)
    cfg = M.MoEConfig(d_model=8, d_ff=8, n_experts=E, top_k=k)
    cap = M._moe_capacity(T, cfg, E)
    ref = _ref_route(jnp.asarray(g), k, E, first, n_local, cap)
    got = M.moe_route(_t(g), k, first, n_local, cap)
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        r, x = np.asarray(r), _np(got[name])
        assert x.shape == r.shape, name
        if r.dtype == np.float32:
            assert x.dtype == np.float32
            assert np.array_equal(x.view(np.int32), r.view(np.int32)), name
        else:
            assert np.array_equal(x.astype(np.int64), r.astype(np.int64)), \
                name
    if case == "overfull":
        assert not bool(got["valid"].all())       # drops happened
    if case in ("ties", "uniform"):
        # a tie goes to the lower expert
        assert bool((got["top_i"][:, :-1] < got["top_i"][:, 1:])
                    [got["top_w"][:, :-1] == got["top_w"][:, 1:]].all())


@pytest.mark.parametrize("T,k,d", [(40, 2, 8), (300, 6, 16)])
def test_moe_combine_matches_scatter_add_bitwise(rng, T, k, d):
    """Each token's pairs added from zero in sorted-pair order: the
    reference's ``zeros.at[st].add(y_pairs)`` bit for bit, with pair
    values over eight decades (so the order shows)."""
    E = 8
    g = _gates("ties", T, E, rng)
    r = M.moe_route(_t(g), k, 0, E, 1 << 20)
    yp = (rng.standard_normal((T * k, d))
          * 10.0 ** rng.integers(-4, 4, (T * k, 1))).astype(np.float32)
    ref = jnp.zeros((T, d), jnp.float32).at[jnp.asarray(_np(r["st"]))].add(
        jnp.asarray(yp))
    got = M._combine(_t(yp), r["order"], T, k)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(ref).view(np.int32))


def _moe_params(rng, E, d, f, router_hot=None):
    """Exactly representable weights: multiples of 1/8 in [-1, 1], so with
    x in {-1, 0, 1} / 2 every product and partial sum in f32 is exact and
    equal logits are equal on both sides."""
    q = lambda *s: (rng.integers(-8, 9, s) / 8.0).astype(np.float32)
    p = {"router": q(d, E), "wi": q(E, d, f), "wg": q(E, d, f),
         "wo": q(E, f, d)}
    p["router"][:, 1] = p["router"][:, 0]                 # experts 0, 1 tie
    p["router"][:, 3] = p["router"][:, 2]                 # and 2, 3
    if router_hot is not None:
        p["router"][:, router_hot] += 1.0                 # an overfull one
    return p


@pytest.mark.parametrize("first,n_local,hot", [(0, 8, None), (0, 8, 5),
                                               (2, 3, 2), (4, 4, 6)])
def test_moe_local_math_matches_reference(rng, first, n_local, hot):
    T, d, f, E = 48, 16, 24, 8
    cfg = dict(d_model=d, d_ff=f, n_experts=E, top_k=2)
    x = (rng.integers(-1, 2, (T, d)) / 2.0).astype(np.float32)
    p = _moe_params(rng, E, d, f, hot)
    cap = M._moe_capacity(T, M.MoEConfig(**cfg), E)
    rp = {k: jnp.asarray(v[first:first + n_local]) if k != "router"
          else jnp.asarray(v) for k, v in p.items()}
    ry, raux = RM.moe_local_math(jnp.asarray(x), rp, RM.MoEConfig(**cfg),
                                 first, n_local, cap)
    y, aux = M.moe_local_math(_t(x), CV.map_tree(lambda _k, v: _t(v), rp),
                              M.MoEConfig(**cfg), first, n_local, cap)
    assert y.dtype == torch.float32 and y.shape == (T, d)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    if hot is not None:
        g = M.moe_route(torch.softmax(_t(x) @ _t(p["router"]), -1), 2,
                        first, n_local, cap)
        assert int(g["counts"].max()) > cap        # an expert overflowed


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(rng, arch):
    """The reduced archs' MoE blocks in bf16: deepseek's with a shared
    expert, phi3.5's without."""
    rblk = ref_arch(arch).reduced().units[-1].blocks[0]
    blk = get_arch(arch).reduced().units[-1].blocks[0]
    assert (blk.moe.n_shared > 0) == (arch == "deepseek-v2-236b")
    rp = jax.device_get(RM.moe_init(jax.random.key(4), rblk.moe))
    p = CV.map_tree(lambda _k, v: _t(v), rp)
    for B, S in ((2, 20), (3, 1), (1, 64)):
        x = rng.standard_normal((B, S, blk.moe.d_model)).astype(np.float32)
        ry, raux = RM.moe_apply(rp, rblk.moe, jnp.asarray(x, jnp.bfloat16),
                                RPLAN)
        y, aux = M.moe_apply(p, blk.moe, _t(x).to(torch.bfloat16), PLAN)
        assert y.dtype == torch.bfloat16 and y.shape == (B, S,
                                                         blk.moe.d_model)
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(ry, np.float32), **LOGIT_TOL)
        np.testing.assert_allclose(float(aux), float(raux), rtol=1e-2)


def test_moe_expert_parallelism_raises():
    """Expert parallelism over a logical (2, 2) mesh runs in one process:
    each batch block's expert shards in turn, summed in shard order
    (``moe_block_by_shards``), the aux averaged over the blocks. An
    expert count the model axis does not divide raises, as in the
    reference (its ``assert``); rank meshes are held in
    tests/test_torch_dist.py."""
    cfg = get_arch("phi3.5-moe-42b-a6.6b").reduced()
    blk = cfg.units[0].blocks[0]
    p = M.moe_init(torch.Generator().manual_seed(0), blk.moe)
    plan = SH.make_plan(LM.make_mesh((2, 2), ("data", "model"),
                                     devices=["cpu"] * 4))
    x = torch.randn((2, 4, blk.moe.d_model),
                    generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    y, aux = M.moe_apply(p, blk.moe, x, plan)
    cap = M._moe_capacity(4, blk.moe, blk.moe.n_experts // 2)
    ys, auxes = zip(*(M.moe_block_by_shards(xb.reshape(4, -1), p["moe"],
                                            blk.moe, 2, cap) for xb in x))
    assert torch.equal(y, torch.stack(ys))
    assert torch.equal(aux, (auxes[0] + auxes[1]) / 2)
    three = SH.make_plan(LM.make_mesh((1, 3), ("data", "model"),
                                      devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="experts must divide model axis"):
        M.moe_apply(p, blk.moe, x, three)
    one = SH.make_plan(LM.make_mesh((1, 1), ("data", "model"),
                                    devices=["cpu"]))
    y, _ = M.moe_apply(p, blk.moe, x, one)       # model axis of 1: local
    assert y.shape == x.shape


# -- MLA ------------------------------------------------------------------------

def _mla_case(rng):
    rcfg = ref_arch("deepseek-v2-236b").reduced().units[0].blocks[0].mla
    cfg = get_arch("deepseek-v2-236b").reduced().units[0].blocks[0].mla
    rp = jax.device_get(RM.mla_init(jax.random.key(6), rcfg))
    # non-zero norm scales, so the norms' scales are held too
    for n in ("q_a_norm", "kv_a_norm"):
        rp["mla"][n]["scale"] = rng.standard_normal(
            rp["mla"][n]["scale"].shape).astype(np.float32) * 0.1
    return rcfg, cfg, rp, CV.map_tree(lambda _k, v: _t(v), rp)


def test_mla_init_matches_reference():
    rcfg, cfg = (a("deepseek-v2-236b").reduced().units[0].blocks[0].mla
                 for a in (ref_arch, get_arch))
    ref = jax.device_get(RM.mla_init(jax.random.key(0), rcfg))
    got = M.mla_init(torch.Generator().manual_seed(0), cfg)
    r = dict(CV.tree_items(ref))
    for k, v in CV.tree_items(got):
        assert tuple(v.shape) == r[k].shape and v.dtype == torch.float32, k
        rs = float(np.std(r[k]))
        if rs == 0:
            assert not v.any(), k
        else:
            assert abs(float(v.std()) - rs) <= 0.15 * rs, k
    assert sorted(r) == sorted(k for k, _ in CV.tree_items(got))


@pytest.mark.parametrize("S,q_offset", [(24, 0), (40, 3)])
def test_mla_apply_matches_reference(rng, S, q_offset):
    rcfg, cfg, rp, p = _mla_case(rng)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None, :] + q_offset
    ry, (rc, rk) = RM.mla_apply(rp, rcfg, jnp.asarray(x), jnp.asarray(pos),
                                RPLAN, q_offset)
    y, (c, k) = M.mla_apply(p, cfg, _t(x), _t(pos), PLAN, q_offset)
    assert c.shape == (2, S, cfg.kv_lora) and k.shape == (2, S, cfg.qk_rope)
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), **F32_TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), **F32_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **FLASH_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(rng, dtype):
    """Absorbed decode over a filled latent cache at several positions per
    row (one row at its first step)."""
    rcfg, cfg, rp, p = _mla_case(rng)
    B, L = 3, 16
    ck = rng.standard_normal((B, L, cfg.kv_lora)).astype(np.float32)
    kr = rng.standard_normal((B, L, cfg.qk_rope)).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 7, 15], np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rcache = {"c_kv": jnp.asarray(ck, jdt), "k_rope": jnp.asarray(kr, jdt)}
    ry, rnc = RM.mla_decode(rp, rcfg, jnp.asarray(x, jdt), jnp.asarray(pos),
                            rcache, RPLAN)
    cache = {"c_kv": _t(ck).to(tdt), "k_rope": _t(kr).to(tdt)}
    y, nc = M.mla_decode(p, cfg, _t(x).to(tdt), _t(pos), cache, PLAN)
    assert y.dtype == tdt and y.shape == (B, 1, cfg.d_model)
    tol = FLASH_TOL if dtype == "float32" else LOGIT_TOL
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ry, np.float32),
                               **tol)
    for name in ("c_kv", "k_rope"):
        got, ref = nc[name].float().numpy(), np.asarray(rnc[name], np.float32)
        assert nc[name].dtype == tdt
        untouched = np.ones((B, L), bool)
        untouched[np.arange(B), pos] = False
        assert np.array_equal(got[untouched], ref[untouched]), name
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, **F32_TOL)
        else:      # one bf16 rounding of values within 4 f32 ulps
            np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)
    assert torch.equal(cache["c_kv"], _t(ck).to(tdt))      # left alone


def _dense_mla_cfg():
    """The reduced deepseek with every layer's MLP dense: no capacity
    binds, so decode must reproduce prefill."""
    cfg = get_arch("deepseek-v2-236b").reduced()
    dense = cfg.units[0].blocks[0]
    assert dense.kind == "mla" and dense.mlp_kind == "dense"
    return dataclasses.replace(cfg, units=(T.UnitSpec(3, (dense,)),))


def test_mla_decode_matches_prefill():
    """The teacher-forced decode of 21 tokens against the prefill's last
    logits, and its latent cache against the prefill's (mla_apply's
    returned c_kv and k_rope at each layer's input)."""
    cfg = _dense_mla_cfg()
    params = T.init_params(3, cfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 21))
    toks = _t(toks.astype(np.int32))
    full = T.serve_prefill(params, cfg, toks, PLAN)
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    for t in range(toks.shape[1]):
        logits, cache = T.serve_decode(params, cfg, toks[:, t], cache, PLAN)
    np.testing.assert_allclose(logits.float().numpy(), full.float().numpy(),
                               **LOGIT_TOL)
    assert cache["pos"].tolist() == [21, 21]
    # layer 0's latent cache: its input is the embedding on both paths
    h = M.embed_apply(params, toks, PLAN)
    bp = T._index(params["units"][0], 0)["b0"]
    _, (c, k) = M.mla_apply(bp, cfg.units[0].blocks[0].mla,
                            M.norm_apply(bp["ln1"], h),
                            torch.arange(21)[None, :], PLAN)
    got = cache["units"][0]["b0"]
    np.testing.assert_allclose(got["c_kv"][0, :, :21].float().numpy(),
                               c.float().numpy(), **LOGIT_TOL)
    np.testing.assert_allclose(got["k_rope"][0, :, :21].float().numpy(),
                               k.float().numpy(), **LOGIT_TOL)
    assert not got["c_kv"][:, :, 21:].any()


# -- parameter rules -------------------------------------------------------------

_RULES_CODE = """
import pickle
from repro.launch.mesh import make_mesh
from repro.runtime import sharding as RS
meshes, leaves = pickle.load(open(IN_PATH, "rb"))
out = {}
for name, (shape, axes) in meshes.items():
    plan = RS.make_plan(make_mesh(shape, axes))
    for path, s in leaves:
        out[(name, path)] = tuple(RS.leaf_sharding(path, s, plan).spec)
pickle.dump(out, open(OUT_PATH, "wb"))
"""


def test_param_rules_match_reference_on_moe_and_mla_leaves(tmp_path):
    """Every leaf of the two reduced archs (the 4-D stacked expert
    weights, the shared experts, the latent projections) and their
    published shapes take the reference's spec on (2,2) and (2,2,2)."""
    meshes = {"2x2": ((2, 2), ("data", "model")),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
    leaves = []
    for arch in MOE_ARCHS:
        for cfg in (get_arch(arch).reduced(), get_arch(arch).config()):
            for k, v in CV.tree_items(T.init_params(0, cfg, device="meta")):
                leaves.append((k, tuple(v.shape)))
    assert any("moe/wi" in k and len(s) == 4 for k, s in leaves)
    assert any("shared/mlp/wi" in k for k, _ in leaves)
    assert any("mla/wkv_b" in k for k, _ in leaves)
    src, dst = str(tmp_path / "in.pkl"), str(tmp_path / "out.pkl")
    with open(src, "wb") as f:
        pickle.dump((meshes, leaves), f)
    run_with_devices(_RULES_CODE.replace("IN_PATH", repr(src))
                     .replace("OUT_PATH", repr(dst)), n_devices=8)
    with open(dst, "rb") as f:
        ref = pickle.load(f)
    for name, (shape, axes) in meshes.items():
        plan = SH.make_plan(LM.make_mesh(
            shape, axes, devices=["cpu"] * int(np.prod(shape))))
        for path, s in leaves:
            assert tuple(SH.leaf_sharding(path, s, plan).spec) == \
                ref[(name, path)], (name, path, s)


def test_published_moe_configs_count_their_parameters():
    """The meta trees of the published configs hold the reference's
    parameter counts (``eval_shape``; 235.2 B and 41.7 B), and the expert
    leaves' shapes."""
    n = lambda cfg: sum(v.numel() for _, v in CV.tree_items(
        T.init_params(0, cfg, device="meta")))
    for a in MOE_ARCHS:
        ref = jax.eval_shape(lambda k: RT.init_params(k, ref_arch(a).config()),
                             jax.random.key(0))
        assert n(get_arch(a).config()) == sum(
            int(np.prod(x.shape)) for x in jax.tree.leaves(ref)), a
    ds, phi = (get_arch(a).config() for a in MOE_ARCHS)
    assert round(n(ds) / 1e8) == 2352 and round(n(phi) / 1e8) == 417
    tree = dict(CV.tree_items(T.init_params(0, phi, device="meta")))
    assert tuple(tree["units/0/b0/moe/wi"].shape) == (32, 16, 4096, 6400)
    tree = dict(CV.tree_items(T.init_params(0, ds, device="meta")))
    assert tuple(tree["units/1/b0/moe/wi"].shape) == (59, 160, 5120, 1536)
    assert tuple(tree["units/1/b0/shared/mlp/wi"].shape) == (59, 5120, 3072)
    cache = T.init_cache(ds, 2, 64, device="meta")
    assert tuple(cache["units"][0]["b0"]["c_kv"].shape) == (1, 2, 64, 512)
    assert tuple(cache["units"][1]["b0"]["k_rope"].shape) == (59, 2, 64, 64)
