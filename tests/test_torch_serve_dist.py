"""Serving over several processes (``repro_torch/launch/serve.py`` on a
rank mesh: ``restore_serving_params`` full and paged, ``make_prefill_fn``,
``make_decode_fn``, ``init_serving_cache``; ``serve/paging.py``'s
collective pin and swap; ``runtime/sharding.py::place_cache``,
``gather_cache``) in gloo worlds on the CPU: one module-scoped world of 2
on (data=1, model=2) and one of 4 on (data=2, model=2).

Five reduced archs, one for each cache kind ``cache_shardings`` names:
gemma3-1b (k/v, its local layers' 16-slot rings wrapping), deepseek-v2
(``c_kv``/``k_rope``, MoE over the model group), zamba2 (mamba2's ``conv``
and ``state``, the shared block's k/v), rwkv6 (``state``, ``sx``,
``sx_cmix``) and whisper-base (``xk``/``xv``, the audio frontend). Each
serves a prompt of P tokens (prefill), then P + G teacher-forced decode
steps into a CACHE-slot cache: B 2 on (1, 2), B 4 (2 rows a rank) and B
1 under ``decode_wide`` (the cache sequence over all 4 ranks) on (2, 2).
The parameters rest as each rank's PARAM_RULES shards, the caches as its
``cache_shardings`` slices.

* Bitwise against the port's one-process run over the same rows (a
  logical (1, 2) mesh, so MoE takes ``moe_block_by_shards``): the global
  prefill logits and every decode step's, each rank's cache slices the
  slices of the one-process cache of its rows. B 4 within the models'
  bound (rtol 0.06, atol 0.05) of the one-process whole-batch run.
* Against the reference's serving on forced host-device meshes, the same
  (1, 2) and (2, 2) (``conftest.run_with_devices``), at
  ``tests/test_torch_models.py``'s bound with its dtypes (the SSM archs
  in f32, deepseek's decode in f32). The reference cannot prefill B 1
  over data=2 (its ``device_put`` of the tokens), nor decode deepseek
  under ``decode_wide`` (its MoE ``shard_map`` splits one token over
  data=2): those hold against its one-device serve (ROADMAP Queue 3).
* A reduced gemma3-1b checkpoint restored full and paged on the ranks:
  every rank's shards bitwise each other and the slices of the
  one-process restore; ``place_cache``/``gather_cache`` round trip.
* ``swap`` collective: a swap on a thread of its own on every rank
  while the ranks page and gather a sharded leaf step by step: every
  step sees one generation on every rank, its gathered leaf that
  generation's; a swap between steps is seen by the next pin everywhere;
  a swap that fails on one rank raises on every rank and keeps the
  generation ids alike.
* One process with a mesh over two devices raises ValueError.
"""
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch import convert as CV
from repro_torch.checkpoint import ckpt as C
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as LM
from repro_torch.launch import serve as S
from repro_torch.models import modules as M
from repro_torch.runtime import dist as D
from repro_torch.runtime import sharding as SH
from repro_torch.serve import PagedParamStore

ARCHS = ("gemma3-1b", "deepseek-v2-236b", "zamba2-7b", "rwkv6-1.6b",
         "whisper-base")
# (prefill, decode) compute dtypes, as tests/test_torch_models.py holds
# each arch against the reference
DTYPES = {"deepseek-v2-236b": ("bfloat16", "float32"),
          "zamba2-7b": ("float32", "float32"),
          "rwkv6-1.6b": ("float32", "float32")}
P_LEN, GEN, CACHE = 16, 8, 32       # rwkv6's prefill: a multiple of 16
LOGIT_TOL = dict(rtol=0.06, atol=0.05)
AXES = ("data", "model")
# mesh name -> (shape, the batches served there)
MESHES = {"1x2": ((1, 2), (2,)), "2x2": ((2, 2), (4, 1))}
TIMEOUT = 300
SWAP_KEY, SWAP_SHAPE, SWAP_MAX_STEPS = "params/embed/table", (64, 32), 1000


def _dtypes(arch):
    return DTYPES.get(arch, ("bfloat16", "bfloat16"))


def _inputs(arch, B):
    """Tokens (B, P_LEN + GEN) and the audio frames (or None), from a
    seed of the arch and batch."""
    cfg = get_arch(arch).reduced()
    rng = np.random.default_rng(ARCHS.index(arch) * 10 + B)
    toks = rng.integers(0, cfg.vocab_size, (B, P_LEN + GEN)).astype(np.int32)
    fe = None
    if cfg.frontend == "audio":
        fe = rng.standard_normal((B, cfg.encoder.n_frames, cfg.d_model)
                                 ).astype(np.float32)
    return toks, fe


def _whole_params(arch):
    from repro_torch.models import transformer as T
    return T.init_params(ARCHS.index(arch), get_arch(arch).reduced(),
                         device="cpu")


def _mesh(shape):
    """A rank mesh inside a world, else a logical one on the CPU."""
    return LM.make_mesh(shape, AXES, devices=["cpu"] * int(np.prod(shape)))


def _compute(dtype):
    old = M.COMPUTE_DTYPE
    M.COMPUTE_DTYPE = getattr(torch, dtype)
    return old


def serve(arch, plan, params, toks, fe):
    """Prefill the first P_LEN of `toks` (B, P_LEN + GEN), then decode all
    of them teacher-forced, through the port's callables on `plan` ->
    (prefill logits, [decode logits], the final cache)."""
    cfg = get_arch(arch).reduced()
    B = toks.shape[0]
    pre_dt, dec_dt = _dtypes(arch)
    old = _compute(pre_dt)
    try:
        pre = S.make_prefill_fn(cfg, plan, B, P_LEN)[0]
        logits = pre(params, torch.from_numpy(toks[:, :P_LEN]),
                     None if fe is None else torch.from_numpy(fe))
        M.COMPUTE_DTYPE = getattr(torch, dec_dt)
        dec = S.make_decode_fn(cfg, plan, B, CACHE)[0]
        cache = S.init_serving_cache(cfg, plan, B, CACHE,
                                     dtype=getattr(torch, dec_dt),
                                     device="cpu")
        steps = []
        for t in range(P_LEN + GEN):
            out, cache = dec(params, torch.from_numpy(toks[:, t]), cache)
            steps.append(out.clone())
    finally:
        M.COMPUTE_DTYPE = old
    return logits.clone(), steps, cache


# -- the ranks' side (run in gloo worlds by runtime/dist.py::launch) -------------

def _swap_steps(plan, streams, swap_at, threaded, n_steps=4):
    """Page SWAP_KEY (its table split over model) through a store on
    `plan` step by step, the store swapped to streams[1] at step
    `swap_at`: between steps (n_steps in all), or on a thread of its own
    (then steps of ~10 ms until two have seen the new generation) ->
    [(generation, the leaf gathered whole as int16 bits)] a step."""
    store = PagedParamStore(streams[0], plan=plan, device="cpu",
                            prefix="params/", cache_bytes=1 << 20)
    shd = SH.leaf_sharding(SWAP_KEY[len("params/"):], SWAP_SHAPE, plan)
    out, thread = [], None
    try:
        for i in range(SWAP_MAX_STEPS):
            if i == swap_at:
                if threaded:
                    thread = threading.Thread(target=store.swap,
                                              args=(streams[1],))
                    thread.start()
                else:
                    store.swap(streams[1])
            with store.pin() as pin:
                leaf = SH.gather_leaf(pin.get(SWAP_KEY), shd)
                out.append((pin.generation,
                            leaf.view(torch.int16).numpy().copy()))
            if not threaded and len(out) == n_steps:
                break
            # every rank sees the same generation at a step, so every
            # rank stops at the same step
            if threaded and [g for g, _ in out[-2:]] == [1, 1]:
                break
            time.sleep(0.01)
        if thread is not None:
            thread.join()
    finally:
        store.close()
    return out


def _swap_failure(plan, streams, rank):
    """Rank 1 swaps to a stream that does not exist while rank 0 swaps to
    a sound one; then both swap to the sound one -> (each swap's error
    text or None, the generation each pin took after each swap)."""
    store = PagedParamStore(streams[0], plan=plan, device="cpu",
                            prefix="params/", cache_bytes=1 << 20)
    out = []
    try:
        for path in (streams[1] + ".missing" if rank == 1 else streams[1],
                     streams[1]):
            try:
                store.swap(path)
                err = None
            except (OSError, RuntimeError) as e:
                err = str(e)
            with store.pin() as pin:
                pin.get(SWAP_KEY)
                out.append((err, pin.generation))
    finally:
        store.close()
    return out


def serve_ranks(rank, shape, ckpt, streams):
    """Every arch served at each batch of the mesh; with `ckpt`, the
    reduced gemma3-1b restored full and paged and its shards; with
    `streams`, the swap steps -> a picklable record."""
    torch.manual_seed(0)
    mesh = _mesh(shape)
    plan = SH.make_plan(mesh)
    name = next(n for n, (s, _) in MESHES.items() if s == shape)
    out = {"coords": mesh.coords, "serve": {}}
    for arch in ARCHS:
        whole = _whole_params(arch)
        shd = SH.param_shardings(whole, plan)
        params = CV.map_tree(lambda k, v: SH.place(v, shd[k]), whole)
        out.setdefault("shapes", {})[arch] = {
            k: tuple(v.shape) for k, v in CV.tree_items(params)}
        for B in MESHES[name][1]:
            pre, steps, cache = serve(arch, plan, params, *_inputs(arch, B))
            out["serve"][(arch, B)] = (pre, steps, {
                k: v.clone() for k, v in CV.tree_items(cache)})
    if ckpt is not None:
        cfg = get_arch("gemma3-1b").reduced()
        full, meta = S.restore_serving_params(ckpt, plan, device="cpu")
        store, pmeta = S.restore_serving_params(ckpt, plan, paged=True,
                                                device="cpu",
                                                cache_bytes=1 << 22)
        with store, store.pin() as pin:
            paged = pin.params()
            out["paged_resident"] = store.cache_resident_bytes
        out["restore"] = {"meta": (meta, pmeta),
                          "full": dict(CV.tree_items(full)),
                          "paged": dict(CV.tree_items(paged))}
        # a cache placed and gathered back: the slices and the whole
        B = 2 * plan.batch_index()[1]
        struct = S.make_decode_fn(cfg, plan, B, CACHE)
        cs = struct[3][1]
        g = torch.Generator().manual_seed(3)
        filled = CV.map_tree(lambda _k, v: torch.randn(
            tuple(v.shape), generator=g).to(v.dtype), struct[2])
        placed = SH.place_cache(filled, cs)
        out["cache_round_trip"] = all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                CV.tree_items(SH.gather_cache(placed, cs)),
                CV.tree_items(filled)))
        out["placed_shapes"] = {k: tuple(v.shape)
                                for k, v in CV.tree_items(placed)}
    if streams is not None:
        out["swap_threaded"] = _swap_steps(plan, streams, 3, True)
        out["swap_between"] = _swap_steps(plan, streams, 2, False)
        out["swap_failure"] = _swap_failure(plan, streams, rank)
    return out


# -- the reference's side ---------------------------------------------------------

_REF = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch
from repro.launch import serve as RS
from repro.launch.mesh import make_mesh
from repro.models import modules as RM
from repro.models import transformer as RT
from repro.runtime import compat
from repro.runtime import sharding as RSH
cases, p_len, cache_len = pickle.load(open(IN_PATH, 'rb'))
out = {}
for (arch, shape, B, one_dev_prefill, one_dev_decode), (flat, toks, fe, dts) \\
        in cases.items():
    cfg = get_arch(arch).reduced()
    like = jax.eval_shape(lambda: RT.init_params(jax.random.key(0), cfg))
    mesh = make_mesh(shape, ('data', 'model'))
    plan = RSH.make_plan(mesh)
    none = RSH.ShardingPlan(mesh=None)

    def params_on(p):
        return jax.tree_util.tree_map_with_path(
            lambda path, _l: jnp.asarray(flat[compat.keystr(path)]) if
            p.mesh is None else jax.device_put(
                flat[compat.keystr(path)], RSH.leaf_sharding(
                    compat.keystr(path), flat[compat.keystr(path)].shape,
                    p)), like)
    RM.COMPUTE_DTYPE = jnp.dtype(dts[0])
    pp = none if one_dev_prefill else plan
    pre, _, shs = RS.make_prefill_fn(cfg, pp, B, p_len)
    args = [jnp.asarray(toks[:, :p_len])] + (
        [] if fe is None else [jnp.asarray(fe)])
    if pp.mesh is not None:
        args = [jax.device_put(a, s) for a, s in zip(args, shs)]
    logits = np.asarray(jax.jit(pre)(params_on(pp), *args), np.float32)
    RM.COMPUTE_DTYPE = jnp.dtype(dts[1])
    dp = none if one_dev_decode else plan
    dec, _, _, (ts, cs) = RS.make_decode_fn(cfg, dp, B, cache_len)
    cache = RT.init_cache(cfg, B, cache_len, jnp.dtype(dts[1]))
    if dp.mesh is not None:
        cache = jax.device_put(cache, cs)
    dec = jax.jit(dec)
    params = params_on(dp)
    steps = []
    for t in range(toks.shape[1]):
        tok = jnp.asarray(toks[:, t])
        if dp.mesh is not None:
            tok = jax.device_put(tok, ts)
        lg, cache = dec(params, tok, cache)
        steps.append(np.asarray(lg, np.float32))
    out[(arch, shape, B)] = (logits, steps)
pickle.dump(out, open(OUT_PATH, 'wb'))
"""


def _ref_cases():
    """{(arch, shape, B, prefill on one device, decode on one device):
    (flat f32 params, tokens, frames, dtypes)}."""
    cases = {}
    for arch in ARCHS:
        flat = {k: v.numpy() for k, v in CV.tree_items(_whole_params(arch))}
        for name, (shape, batches) in MESHES.items():
            for B in batches:
                toks, fe = _inputs(arch, B)
                wide = B == 1 and shape == (2, 2)
                cases[(arch, shape, B, wide,
                       wide and arch == "deepseek-v2-236b")] = (
                    flat, toks, fe, _dtypes(arch))
    return cases


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's logits, its subprocess started first and joined
    by the first test that reads it, so it runs beside the worlds."""
    d = tmp_path_factory.mktemp("ref_serve_dist")
    src, dst = str(d / "in.pkl"), str(d / "out.pkl")
    with open(src, "wb") as f:
        pickle.dump((_ref_cases(), P_LEN, CACHE), f)
    err = []

    def run():
        try:
            run_with_devices(_REF.replace("IN_PATH", repr(src))
                             .replace("OUT_PATH", repr(dst)), n_devices=4)
        except BaseException as e:       # re-raised by the reader
            err.append(e)
    th = threading.Thread(target=run)
    th.start()

    def result():
        th.join()
        if err:
            raise err[0]
        with open(dst, "rb") as f:
            return pickle.load(f)
    return result


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A reduced gemma3-1b saved (ceaz, step 1), and two raw streams of
    one small tree whose `embed/table` the model axis splits."""
    d = str(tmp_path_factory.mktemp("serve_dist_ckpt"))
    C.save_checkpoint(d, _whole_params("gemma3-1b"), 1, device="cpu")
    raw = C.CheckpointConfig(mode="raw")
    streams = []
    for i in range(2):
        sd = str(tmp_path_factory.mktemp(f"swap_{i}"))
        rng = np.random.default_rng(40 + i)
        C.save_checkpoint(sd, {"params": {
            "embed": {"table": rng.standard_normal((64, 32)).astype(
                np.float32) + 3 * i},
            "norm": np.ones((32,), np.float32)}}, 1, cfg=raw, device="cpu")
        streams.append(f"{sd}/step_00000001/{C.LEAVES_STREAM}")
    return d, streams


@pytest.fixture(scope="module")
def worlds(reference, checkpoint):
    """The world of 2 (with the restores and the swaps) and the world of
    4 (with the restores), one launch each."""
    ckpt, streams = checkpoint
    two = D.launch(serve_ranks, 2, args=((1, 2), ckpt, streams),
                   timeout=TIMEOUT, threads=1)
    four = D.launch(serve_ranks, 4, args=((2, 2), ckpt, None),
                    timeout=TIMEOUT, threads=1)
    return {"1x2": [r.result for r in two], "2x2": [r.result for r in four]}


# -- the port's one-process runs --------------------------------------------------

def _logical_plan(shape):
    return SH.make_plan(_mesh(shape))


def _block_cases():
    return [(arch, name, B) for arch in ARCHS
            for name, (_, batches) in MESHES.items() for B in batches]


@pytest.fixture(scope="module")
def one_process():
    """{(arch, mesh, B): [(prefill, steps, cache)] over each rank block's
    rows on a logical (1, 2) mesh, and (arch, 4) the whole batch of 4 on
    a logical (2, 2) one."""
    out = {}
    plan = _logical_plan((1, 2))
    for arch in ARCHS:
        params = _whole_params(arch)
        for name, (shape, batches) in MESHES.items():
            for B in batches:
                dp = shape[0] if B % shape[0] == 0 else 1
                per = B // dp
                blocks = []
                toks, fe = _inputs(arch, B)
                for i in range(dp):
                    rows = slice(i * per, (i + 1) * per)
                    blocks.append(serve(arch, plan, params, toks[rows],
                                        None if fe is None else fe[rows]))
                out[(arch, name, B)] = blocks
        # the whole batch of 4 on the logical (2, 2) mesh: MoE at the
        # capacity of one data position's rows, as the reference's
        out[(arch, 4)] = serve(arch, _logical_plan((2, 2)), params,
                               *_inputs(arch, 4))
    return out


def _rank_slice(whole_rows, arch, shape, B, coords):
    """The slices of a cache over one block's rows that the rank at
    `coords` holds (every split dimension but the batch rows)."""
    cfg = get_arch(arch).reduced()
    plan = _logical_plan(shape)
    _, _, struct, _ = S.make_decode_fn(cfg, plan, B, CACHE)
    shards = S.ServeShards(cfg, plan, struct, B % shape[0] == 0)
    out = {}
    for k, v in CV.tree_items(whole_rows):
        if k == "pos":                  # replicated: every row's
            out[k] = torch.full((B,), P_LEN + GEN, dtype=v.dtype)
            continue
        sh = shards.cache_shd.get(k)
        if sh is None or not shards.slice_dims(sh):
            out[k] = v
            continue
        out[k] = v[SH.shard_slices(tuple(v.shape), sh, coords=coords,
                                   dims=shards.slice_dims(sh))]
    return out


# -- serving ---------------------------------------------------------------------

@pytest.mark.parametrize("arch,name,B", _block_cases())
def test_ranks_match_one_process_bitwise(worlds, one_process, arch, name,
                                         B):
    """Global logits and every rank's cache slices bitwise the port's
    one-process run over the rank's rows; decode writes reach every
    model rank's slice."""
    shape = MESHES[name][0]
    blocks = one_process[(arch, name, B)]
    want_pre = torch.cat([b[0] for b in blocks])
    want_steps = [torch.cat([b[1][t] for b in blocks])
                  for t in range(P_LEN + GEN)]
    for r in worlds[name]:
        pre, steps, cache = r["serve"][(arch, B)]
        assert pre.shape == (B, get_arch(arch).reduced().vocab_size)
        assert torch.equal(pre, want_pre), (arch, name, B, r["coords"])
        for t, (got, want) in enumerate(zip(steps, want_steps)):
            assert torch.equal(got, want), (arch, name, B, t)
        c = r["coords"]
        i = c["data"] if len(blocks) > 1 else 0
        want = _rank_slice(dict(CV.tree_items(blocks[i][2])), arch, shape,
                           B, c)
        assert sorted(cache) == sorted(want)
        for k, v in want.items():
            assert cache[k].shape == v.shape and torch.equal(cache[k], v), \
                (arch, name, B, c, k)
        if arch == "gemma3-1b":
            # positions 0..23 reach every rank's slice of the rings (16
            # slots) and, but for decode_wide's last quarter (24-31), of
            # the global layer's 32 slots
            for k in cache:
                if k.endswith(("/k", "/v")):
                    last = B == 1 and c == {"data": 1, "model": 1} \
                        and "/b2/" in k
                    assert bool(cache[k].any()) != last, (name, B, c, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_data_split_within_bound_of_whole_batch(worlds, one_process, arch):
    """B 4 over two data ranks against one process's whole batch."""
    pre, steps, _ = worlds["2x2"][0]["serve"][(arch, 4)]
    wpre, wsteps, _ = one_process[(arch, 4)]
    np.testing.assert_allclose(pre.float().numpy(), wpre.float().numpy(),
                               **LOGIT_TOL)
    for got, want in zip(steps, wsteps):
        np.testing.assert_allclose(got.float().numpy(),
                                   want.float().numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("arch,name,B", _block_cases())
def test_ranks_match_reference_mesh(worlds, reference, arch, name, B):
    """Rank 0's logits against the reference's serving on the same mesh
    of host devices, at the models' bound and dtypes."""
    ref = reference()[(arch, MESHES[name][0], B)]
    pre, steps, _ = worlds[name][0]["serve"][(arch, B)]
    np.testing.assert_allclose(pre.float().numpy(), ref[0],
                               err_msg=f"{arch} {name} B{B} prefill",
                               **LOGIT_TOL)
    assert len(steps) == len(ref[1])
    for t, (got, want) in enumerate(zip(steps, ref[1])):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   err_msg=f"{arch} {name} B{B} step {t}",
                                   **LOGIT_TOL)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ranks_hold_their_shards(worlds, name):
    """Each rank's parameters are its PARAM_RULES shards: the model axis
    halves the sharded leaves."""
    shape = MESHES[name][0]
    for arch in ARCHS:
        whole = {k: tuple(v.shape) for k, v in
                 CV.tree_items(_whole_params(arch))}
        plan = _logical_plan(shape)
        for r in worlds[name]:
            got = r["shapes"][arch]
            halved = 0
            for k, s in whole.items():
                sh = SH.leaf_sharding(k, s, plan)
                cut = SH.shard_slices(s, sh, coords=r["coords"])
                assert got[k] == tuple(c.stop - c.start for c in cut), k
                halved += got[k] != s
            assert halved > 0, arch


# -- restore, paging and cache placement -----------------------------------------

@pytest.mark.parametrize("name", sorted(MESHES))
def test_rank_restores_match_one_process(worlds, checkpoint, name):
    """Full and paged rank restores bitwise each other and the slices of
    the one-process restore, in bf16."""
    ckpt, _ = checkpoint
    want, meta = S.restore_serving_params(ckpt, SH.ShardingPlan(None),
                                          device="cpu")
    want = dict(CV.tree_items(want))
    shape = MESHES[name][0]
    plan = _logical_plan(shape)
    for r in worlds[name]:
        rec = r["restore"]
        assert rec["meta"] == (meta, meta) == ({"step": 1}, {"step": 1})
        assert sorted(rec["full"]) == sorted(rec["paged"]) == sorted(want)
        for k, w in want.items():
            sh = SH.leaf_sharding(k, tuple(w.shape), plan)
            cut = w[SH.shard_slices(tuple(w.shape), sh, coords=r["coords"])]
            for kind in ("full", "paged"):
                got = rec[kind][k]
                assert got.dtype == torch.bfloat16, (kind, k)
                assert torch.equal(got.view(torch.int16),
                                   cut.view(torch.int16)), (kind, k)
        # the pager's budget counts the placed (shard-sized) bytes
        assert r["paged_resident"] == sum(
            v.numel() * v.element_size() for v in rec["paged"].values())


@pytest.mark.parametrize("name", sorted(MESHES))
def test_place_and_gather_cache(worlds, name):
    """place_cache keeps the rank's cache_shardings slices (the wide
    sequence over data and model at once) and gather_cache restores the
    whole cache bitwise."""
    shape = MESHES[name][0]
    cfg = get_arch("gemma3-1b").reduced()
    for r in worlds[name]:
        assert r["cache_round_trip"]
        B = 2 * shape[0]
        _, _, struct, (_, cs) = S.make_decode_fn(cfg, _logical_plan(shape),
                                                 B, CACHE)
        shd = dict(CV.tree_items(cs))
        for k, v in CV.tree_items(struct):
            cut = SH.shard_slices(tuple(v.shape), shd[k], coords=r["coords"])
            assert r["placed_shapes"][k] == tuple(c.stop - c.start
                                                  for c in cut), k
        seq = r["placed_shapes"]["units/0/b2/k"][2]
        assert seq == CACHE // 2     # the global layer's sequence halved


# -- the collective swap ----------------------------------------------------------

def _truths(checkpoint):
    _, streams = checkpoint
    out = []
    for s in streams:
        with PagedParamStore(s, device="cpu", prefix="params/") as st, \
                st.pin() as pin:
            out.append(pin.get("params/embed/table").view(torch.int16)
                       .numpy())
    return out


def test_collective_swap_never_mixes_generations(worlds, checkpoint):
    """A swap on a thread of every rank mid-stream: at every step both
    ranks pinned one generation, and the leaf they gathered from their
    shards is that generation's whole leaf."""
    truth = _truths(checkpoint)
    ranks = worlds["1x2"]
    steps = [r["swap_threaded"] for r in ranks]
    gens = [[g for g, _ in s] for s in steps]
    assert gens[0] == gens[1], gens
    assert gens[0][0] == 0 and gens[0][-1] == 1, gens
    assert gens[0] == sorted(gens[0])
    for s in steps:
        for g, leaf in s:
            assert np.array_equal(leaf, truth[g]), g


def test_swap_between_steps_seen_by_the_next_pin(worlds, checkpoint):
    truth = _truths(checkpoint)
    for r in worlds["1x2"]:
        gens = [g for g, _ in r["swap_between"]]
        assert gens == [0, 0, 1, 1]
        for g, leaf in r["swap_between"]:
            assert np.array_equal(leaf, truth[g])


def test_failed_swap_on_one_rank_fails_on_every_rank(worlds):
    """A swap that fails on one rank raises on both and leaves both on
    the old generation; the next swap lands on both with one id."""
    r0, r1 = (r["swap_failure"] for r in worlds["1x2"])
    assert r1[0][0] is not None and "missing" in r1[0][0]
    assert r0[0][0] == "swap failed on ranks [1]"
    assert r0[0][1] == r1[0][1] == 0
    assert r0[1] == r1[1] and r0[1][0] is None and r0[1][1] > 0


def test_one_process_mesh_over_two_devices_raises(checkpoint):
    ckpt, _ = checkpoint
    two = SH.make_plan(LM.make_mesh((1, 2), AXES,
                                    devices=["cuda:0", "cuda:1"]))
    cfg = get_arch("gemma3-1b").reduced()
    with pytest.raises(ValueError, match="one process a position"):
        S.restore_serving_params(ckpt, two, device="cpu")
    with pytest.raises(ValueError, match="one process a position"):
        S.init_serving_cache(cfg, two, 2, CACHE, device="cpu")
    with pytest.raises(ValueError, match="one process a position"):
        S.make_prefill_fn(cfg, two, 2, P_LEN)[0](
            _whole_params("gemma3-1b"),
            torch.zeros((2, P_LEN), dtype=torch.int32))
