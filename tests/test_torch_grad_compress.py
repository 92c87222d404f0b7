"""The port's fixed-width gradient exchange and AdamW
(src/repro_torch/optim/) against the JAX reference on the CPU.

  * ``compressed_cross_pod_mean``: the reference's own, run inside a
    ``shard_map`` over a 4-device 'pod' mesh (subprocess), 3 steps of
    error feedback; the port's no-group form on the same per-pod
    gradients. Pod means and residuals are held bitwise at every step.
  * AdamW: 3 steps, each taken by both from the reference's state of the
    step before. Global norms within the f32 summation bound; params and
    bf16 moments within ``adamw.step_deviation`` (derived there), a moment
    that differs only where its f32 value lies within that bound of a
    bf16 rounding boundary, counted.
  * the leaf functions (quantize, pack, scale) bitwise on NaN/Inf/zero
    leaves and odd lengths; the bf16 tree conversion round trip; the
    in-memory snapshot; the device defaults.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.optim import adamw as RA
from repro.optim import grad_compress as RG
from repro.runtime import compat
from repro_torch import convert as CV
from repro_torch.optim import adamw as PA
from repro_torch.optim import grad_compress as GC

PODS, STEPS = 4, 3
SHAPES = {"layers": [{"attn": {"wq": (24, 2, 8), "q_norm": {"scale": (8,)}},
                      "mlp": {"wi": (24, 40), "wo": (40, 24)}}] * 2,
          "embed": (50, 24)}


def _tree(fn):
    def go(node, path):
        if isinstance(node, dict):
            return {k: go(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [go(v, path + (i,)) for i, v in enumerate(node)]
        return fn(node, path)
    return go(SHAPES, ())


def _grads(step: int):
    rng = np.random.default_rng(100 + step)
    return _tree(lambda s, _: (rng.standard_normal((PODS,) + s)
                               * 0.3).astype(np.float32))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's exchange under a 4-pod shard_map and its AdamW
    (jitted, as the train step runs it) for STEPS steps."""
    tmp = tmp_path_factory.mktemp("exch")
    rng = np.random.default_rng(5)
    params = _tree(lambda s, path: np.zeros(s, np.float32) if "q_norm" in
                   path else (rng.standard_normal(s) * 0.05).astype(
                       np.float32))
    np.save(tmp / "params.npy", np.array(params, dtype=object),
            allow_pickle=True)
    for s in range(STEPS):
        np.save(tmp / f"g{s}.npy", np.array(_grads(s), dtype=object),
                allow_pickle=True)
    run_with_devices(textwrap.dedent(f"""
        import pickle, jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.launch import mesh as M
        from repro.optim import adamw as A
        from repro.optim.grad_compress import (CompressionConfig,
                                               compressed_cross_pod_mean)
        from repro.runtime import compat
        tmp = {str(tmp)!r}
        mesh = M.make_mesh(({PODS},), ('pod',))
        ccfg, acfg = CompressionConfig(bits=8), A.AdamWConfig()
        def exchange(cfg):
            def per_pod(g, r):
                g = jax.tree.map(lambda x: x[0], g)
                r = jax.tree.map(lambda x: x[0], r)
                m, nr = compressed_cross_pod_mean(g, r, cfg)
                return m, jax.tree.map(lambda x: x[None], nr)
            return jax.jit(compat.shard_map(
                per_pod, mesh=mesh, in_specs=(P('pod'), P('pod')),
                out_specs=(P(), P('pod')), axis_names={{'pod'}},
                check_vma=False))
        exch = exchange(ccfg)
        exch_noef = exchange(CompressionConfig(bits=4, error_feedback=False))
        upd = jax.jit(lambda p, g, s: A.adamw_update(p, g, s, acfg))
        params = np.load(tmp + '/params.npy', allow_pickle=True).item()
        params = jax.tree.map(jnp.asarray, params)
        opt = A.adamw_init(params, acfg)
        out = []
        for s in range({STEPS}):
            g = np.load(tmp + f'/g{{s}}.npy', allow_pickle=True).item()
            if s == 0:
                res = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32),
                                   g)
            # without error feedback, from a residual it must not read
            noef = exch_noef(g, jax.tree.map(lambda x: x + 1.0, res))
            mean, res = exch(g, res)
            new_p, new_opt, om = upd(params, mean, opt)
            out.append(jax.tree.map(np.asarray, dict(
                mean_noef=noef[0], res_noef=noef[1],
                mean=mean, res=res, params=params, opt=opt, new_p=new_p,
                new_opt=new_opt, gn=om['grad_norm'], lr=om['lr'])))
            params, opt = new_p, new_opt
        pickle.dump(out, open(tmp + '/out.pkl', 'wb'))
    """), n_devices=PODS)
    import pickle
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


def test_exchange_matches_reference_shard_map(reference):
    cfg = GC.CompressionConfig(bits=8)
    residual = None
    for s, ref in enumerate(reference):
        grads = CV.tree_from_reference(_grads(s), device="cpu")
        if residual is None:
            residual = GC.ef_init(grads, device="cpu")
        mean, residual = GC.compressed_cross_pod_mean(grads, residual, cfg,
                                                      device="cpu")
        ref_mean = dict(CV.tree_items(ref["mean"]))
        ref_res = dict(CV.tree_items(ref["res"]))
        assert list(mean) == list(ref_mean)
        for k in mean:
            assert mean[k].numpy().tobytes() == ref_mean[k].tobytes(), (s, k)
            assert residual[k].numpy().tobytes() == ref_res[k].tobytes(), \
                (s, k)


def test_exchange_without_error_feedback_matches_reference(reference):
    """error_feedback=False at 4 bits: the pod mean of the gradients alone
    is the reference's, and the residual comes back as it went in."""
    cfg = GC.CompressionConfig(bits=4, error_feedback=False)
    residual = None
    for s, ref in enumerate(reference):
        grads = CV.tree_from_reference(_grads(s), device="cpu")
        if residual is None:
            residual = GC.ef_init(grads, device="cpu")
        given = {k: v + 1.0 for k, v in residual.items()}
        mean, back = GC.compressed_cross_pod_mean(grads, given, cfg,
                                                  device="cpu")
        ref_mean = dict(CV.tree_items(ref["mean_noef"]))
        ref_res = dict(CV.tree_items(ref["res_noef"]))
        for k in mean:
            assert mean[k].numpy().tobytes() == ref_mean[k].tobytes(), (s, k)
            assert back[k].numpy().tobytes() == ref_res[k].tobytes() == \
                given[k].numpy().tobytes(), (s, k)
        _, residual = GC.compressed_cross_pod_mean(
            grads, residual, GC.CompressionConfig(bits=8), device="cpu")


def _check_adamw_step(ref, cfg, step):
    """One port step from the reference's inputs of that step."""
    params = CV.tree_from_reference(ref["params"], device="cpu")
    opt = CV.opt_state_from_reference(ref["opt"], device="cpu")
    grads = CV.tree_from_reference(ref["mean"], device="cpu")
    new_p, new_opt, om = PA.adamw_update(params, grads, opt, cfg,
                                         device="cpu")
    # each norm against the float64 one: the port's blocked sum, and the
    # reference's XLA sum of unknown order
    exact, err_p = PA.norm_error(grads)
    _, err_r = PA.norm_error(grads, blocked=False)
    gn_p, gn_r = float(om["grad_norm"]), float(ref["gn"])
    assert abs(gn_p - exact) <= err_p and abs(gn_r - exact) <= err_r
    assert float(om["lr"]) == float(ref["lr"])
    assert int(new_opt["step"]) == int(ref["new_opt"]["step"]) == step
    rho = PA.clip_rho(exact, (gn_p, gn_r), cfg)
    clip = PA.clip_factor(exact, cfg)
    ref_p = dict(CV.tree_items(ref["new_p"]))
    flips = 0
    for k in new_p:
        dev = PA.step_deviation(params[k], grads[k], opt["mu"][k],
                                opt["nu"][k], step, cfg, clip, rho)
        d = (new_p[k].to(torch.float64)
             - torch.tensor(ref_p[k], dtype=torch.float64)).abs()
        assert bool((d <= dev["p"]).all()), (step, k, float(d.max()))
        for m in ("mu", "nu"):
            ref_m = CV.tree_from_reference(ref["new_opt"][m],
                                           device="cpu")[k]
            n, ok = PA.bf16_moment_check(dev[m + "32"], dev[m],
                                          new_opt[m][k], ref_m)
            assert ok, (step, k, m)
            flips += n
    return flips


def test_adamw_steps_match_reference(reference):
    cfg = PA.AdamWConfig()
    for s, ref in enumerate(reference):
        _check_adamw_step(ref, cfg, s + 1)


@pytest.mark.parametrize("scale", [1e-3, 3.0])
def test_adamw_matches_reference_clip_both_sides(scale):
    """Global norms under and over grad_clip: the clip factor 1, and the
    clip taken from two differently summed norms."""
    rng = np.random.default_rng(int(scale * 1000))
    params = {"a": {"w": (rng.standard_normal((64, 33)) * 0.05).astype(
        np.float32), "n": np.zeros(33, np.float32)},
        "b": [(rng.standard_normal(1000) * 0.1).astype(np.float32)]}
    rcfg, cfg = RA.AdamWConfig(), PA.AdamWConfig()
    upd = jax.jit(lambda p, g, s: RA.adamw_update(p, g, s, rcfg))
    p, opt = jax.tree.map(jnp.asarray, params), RA.adamw_init(params, rcfg)
    for step in range(1, STEPS + 1):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                    * scale).astype(np.float32), params)
        new_p, new_opt, om = upd(p, jax.tree.map(jnp.asarray, g), opt)
        ref = jax.tree.map(np.asarray, dict(
            params=p, opt=opt, mean=g, new_p=new_p, new_opt=new_opt,
            gn=om["grad_norm"], lr=om["lr"]))
        _check_adamw_step(ref, cfg, step)
        p, opt = new_p, new_opt


def test_global_norm_sums_in_leaf_order():
    """Leaf by leaf in leaf order, each leaf's squares in blocks of
    sqrt_block(n) values (n = 1, a whole block, a ragged tail)."""
    tree = CV.tree_from_reference(_grads(0), device="cpu")
    tree["one"], tree["ragged"] = torch.ones(1) * 3, torch.randn(
        1000, generator=torch.Generator().manual_seed(0))
    total = 0
    for x in tree.values():
        sq = torch.square(x).reshape(-1)
        b = PA.sqrt_block(sq.numel())
        parts = [sq[i:i + b].sum() for i in range(0, sq.numel(), b)]
        total = total + torch.stack(parts).sum()
    assert PA.global_norm(tree).item() == torch.sqrt(total).item()
    exact, err = PA.norm_error(tree)
    assert abs(PA.global_norm(tree).item() - exact) <= err


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
@pytest.mark.parametrize("case", ["normal", "nan", "inf", "zeros", "ties"])
def test_leaf_functions_match_reference(bits, case):
    """Codes, scales, packed words and the round trip, bitwise, on odd
    lengths, non-finite leaves (scale NaN/Inf, NaN codes as 0) and
    maxima on f32 midpoints of max/half (the FMA the reference's
    compiled scale takes)."""
    rng = np.random.default_rng(bits)
    g = (rng.standard_normal(1001) * 0.2).astype(np.float32)
    if case == "nan":
        g[3] = np.nan
    elif case == "inf":
        g[10] = -np.inf
    elif case == "zeros":
        g[:] = 0
    elif case == "ties":
        g[7] = 1.5            # 1.5 * f32(1/7) lies on an f32 midpoint
    q, sc = GC._quantize_leaf(torch.from_numpy(g), bits)
    rq, rsc = jax.jit(RG._quantize_leaf, static_argnums=1)(jnp.asarray(g),
                                                           bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert sc.numpy().tobytes() == np.asarray(rsc).tobytes()
    rec, packed, sc2 = GC.compress_decompress_leaf(torch.from_numpy(g), bits)
    rrec, rpacked, _ = jax.jit(RG.compress_decompress_leaf,
                               static_argnums=1)(jnp.asarray(g), bits)
    np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                  np.asarray(rpacked))
    assert rec.numpy().tobytes() == np.asarray(rrec).tobytes()
    if case in ("nan", "inf"):
        assert np.isnan(rec.numpy()).all()


def test_row_scales_match_compiled_reference():
    """Maxima with short mantissas put max*f32(1/half) on f32 midpoints
    often; the reference's compiled FMA rounds those up."""
    rng = np.random.default_rng(3)
    m = (rng.integers(1, 1 << 8, 4000).astype(np.float64)
         * 2.0 ** rng.integers(-30, 10, 4000)).astype(np.float32)
    v = np.stack([m, np.zeros_like(m)], 1)
    for bits in (2, 4, 8, 16):
        half = (1 << (bits - 1)) - 1
        want = jax.jit(lambda x: jnp.max(jnp.abs(x), axis=1) / half
                       + 1e-30)(v)
        got = GC.row_scales(torch.from_numpy(m), bits)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))


def test_tree_conversion_round_trip_bf16():
    """Keys are compat.keystr's, in jax.tree.leaves order; bf16 moments
    cross bit for bit through uint16 views."""
    rng = np.random.default_rng(9)
    params = _tree(lambda s, _: rng.standard_normal(s).astype(np.float32))
    state = RA.adamw_init(params, RA.AdamWConfig())
    state = jax.tree.map(lambda x: np.asarray(
        (jnp.asarray(rng.standard_normal(x.shape)).astype(x.dtype))
        if x.ndim else x + 7), state)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    flat = CV.tree_from_reference(params, device="cpu")
    assert list(flat) == [compat.keystr(p) for p, _ in leaves]
    for (_, a), t in zip(leaves, flat.values()):
        assert t.dtype == torch.float32 and a.tobytes() == t.numpy().tobytes()
    back = CV.tree_to_reference(flat, like=params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    port = CV.opt_state_from_reference(state, device="cpu")
    mu = next(iter(port["mu"].values()))
    assert mu.dtype == torch.bfloat16 and int(port["step"]) == 7
    again = CV.opt_state_to_reference(port, like=state)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_snapshot_round_trip_matches_reference():
    """The in-memory snapshot through the port's facade (rel, predictor
    'auto', fused): every record equals the reference's, and every leaf
    decodes to its bytes."""
    from conftest import assert_streams_bit_identical
    rng = np.random.default_rng(11)
    grads = {"smooth": np.cumsum(rng.standard_normal(6000)).astype(
        np.float32), "noise": rng.standard_normal((80, 70)).astype(
        np.float32), "small": rng.standard_normal(100).astype(np.float32)}
    snap = GC.snapshot_grads(grads, device="cpu")
    ref = RG.snapshot_grads(grads)
    assert list(snap) == sorted(grads) == list(ref)
    assert snap["small"] is not None and isinstance(snap["small"],
                                                    np.ndarray)
    for k in ("smooth", "noise"):
        port_c = snap[k]
        ref_c = CV.from_reference(ref[k])
        assert_streams_bit_identical(port_c, ref_c)
    back = GC.restore_grad_snapshot(snap, device="cpu")
    ref_back = RG.restore_grad_snapshot(ref)
    for k in grads:
        assert back[k].tobytes() == np.asarray(ref_back[k]).tobytes()


@pytest.mark.parametrize("overlap", [True, False])
def test_snapshot_stream_matches_reference(tmp_path, overlap):
    """The streamed snapshot: a nested tree of torch leaves (a smooth and a
    noise-like lossy leaf, a non-finite one, a small one, an int one)
    gives the reference's records and payloads for the same numpy
    leaves; each package restores the other's stream to the same bytes,
    and every raw leaf bit-exact."""
    rng = np.random.default_rng(12)
    ref_tree = {"layers": [
        {"w": np.cumsum(rng.standard_normal((80, 100)), axis=1)
         .astype(np.float32),
         "n": rng.standard_normal(5000).astype(np.float32)}],
        "bad": np.full(4096, np.inf, np.float32),
        "small": rng.standard_normal(100).astype(np.float32),
        "count": np.arange(4, dtype=np.int32)}
    port_tree = {"layers": [{k: torch.from_numpy(v.copy())
                             for k, v in ref_tree["layers"][0].items()}],
                 **{k: torch.from_numpy(ref_tree[k].copy())
                    for k in ("bad", "small", "count")}}
    pp, pr = str(tmp_path / "p.ceazs"), str(tmp_path / "r.ceazs")
    st = GC.snapshot_grads_to_stream(pp, port_tree, overlap=overlap,
                                     device="cpu")
    rst = RG.snapshot_grads_to_stream(pr, ref_tree, overlap=overlap)
    assert (st["raw_bytes"], st["stored_bytes"], st["n_records"]) == \
        (rst["raw_bytes"], rst["stored_bytes"], rst["n_records"])
    from repro_torch.io import engine as E
    with E.StreamReader(pp) as a, E.StreamReader(pr) as b:
        assert a.records == b.records
        assert [a.payload(i) for i in range(len(a))] == \
            [b.payload(i) for i in range(len(b))]
        assert {k: v for k, v in a.meta.items() if k != "telemetry"} == \
            {"kind": "grad_snapshot", "eb_rel": 1e-3, "block_size": 4096}
    mine = GC.restore_grad_snapshot_stream(pr, device="cpu")
    theirs = RG.restore_grad_snapshot_stream(pp)
    keys = ["bad", "count", "layers/0/n", "layers/0/w", "small"]
    assert list(mine) == list(theirs) == keys
    for k in keys:
        assert mine[k].tobytes() == np.asarray(theirs[k]).tobytes(), k
    for k in ("bad", "count", "small"):
        assert mine[k].tobytes() == ref_tree[k].tobytes(), k


def test_entry_points_need_a_card_unless_cpu(tmp_path):
    t = {"w": torch.zeros(4, 3)}
    calls = [lambda: GC.ef_init(t), lambda: PA.adamw_init(t, PA.AdamWConfig()),
             lambda: PA.adamw_update(t, t, PA.adamw_init(
                 t, PA.AdamWConfig(), device="cpu"), PA.AdamWConfig()),
             lambda: GC.compressed_cross_pod_mean(
                 {"w": torch.zeros(2, 4, 3)}, {"w": torch.zeros(2, 4, 3)},
                 GC.CompressionConfig()),
             lambda: GC.snapshot_grads({"w": np.zeros(5000, np.float32)}),
             lambda: GC.restore_grad_snapshot({}),
             lambda: CV.tree_from_reference({"w": np.zeros(3)})]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the snapshot streams are ported: on the card by default, raising
    # without one; with device='cpu' they run
    path = str(tmp_path / "snap.ceazs")
    grads = {"w": np.linspace(0, 1, 5000, dtype=np.float32)}
    GC.snapshot_grads_to_stream(path, grads, device="cpu")
    assert GC.restore_grad_snapshot_stream(path, device="cpu")["w"].shape \
        == (5000,)
    for fn, args in ((GC.snapshot_grads_to_stream,
                      (str(tmp_path / "q.ceazs"), grads)),
                     (GC.restore_grad_snapshot_stream, (path,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)
    assert GC.payload_fraction(8) == RG.payload_fraction(8) == 0.5
