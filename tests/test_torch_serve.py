"""The port's serving entry points (``repro_torch/launch/serve.py``)
against the reference's ``launch/serve.py``, on the CPU.

* ``cache_shardings`` and the decode and prefill shardings equal the
  reference's on (2,2) and (2,2,2) meshes, computed by one subprocess
  with 8 host devices (``conftest.run_with_devices``); the port's meshes
  are logical (the CPU on every position), which is all the rules read.
* A reduced gemma3-1b checkpoint saved by the reference restores through
  the port with bf16 bits equal to the reference's restore, and one
  saved by the port restores through the reference likewise; paged
  leaves are bitwise the full restore's.
* The callables' argument structs (meta tensors) equal the reference's
  ``eval_shape`` structs, and the whole slice — restore, prefill,
  teacher-forced and greedy decode — stays within the reference's
  decode-against-prefill bound (rtol 0.06, atol 0.05; the arithmetic is
  bf16 on both sides, rounded in other places: see
  ``tests/test_torch_models.py``).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.checkpoint import ckpt as RC
from repro.configs import get_arch as ref_arch
from repro.launch import serve as RS
from repro.models import transformer as RT
from repro.runtime.sharding import ShardingPlan as RPlan
from repro_torch import convert as CV
from repro_torch.checkpoint import ckpt as C
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import mesh as LM
from repro_torch.launch import serve as S
from repro_torch.models import transformer as T
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.sharding import ShardingPlan

ARCH_IDS = sorted(ARCHS)
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
BATCHES = (4, 1)            # divides the DP size / does not (wide cache)
CACHE_LEN, SEQ = 32, 24
LOGIT_TOL = dict(rtol=0.06, atol=0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module's small arrays: the suite runs
    its files in parallel workers, and timing tests share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_REF_CODE = """
import pickle
import jax
from repro.configs import get_arch
from repro.launch import serve as RS
from repro.launch.mesh import make_mesh
from repro.runtime import compat
from repro.runtime import sharding as RSH
meshes, archs, batches, cache_len, seq = pickle.load(open(IN_PATH, "rb"))
spec = lambda s: None if s is None else tuple(s.spec)
out = {}
for name, (shape, axes) in meshes.items():
    plan = RSH.make_plan(make_mesh(shape, axes))
    for arch in archs:
        cfg = get_arch(arch).reduced()
        for b in batches:
            _, _, _, (ts, cs) = RS.make_decode_fn(cfg, plan, b, cache_len)
            leaves = jax.tree_util.tree_flatten_with_path(
                cs, is_leaf=lambda x: x is None)[0]
            out[(name, arch, b, "decode")] = (spec(ts), {
                compat.keystr(p): spec(s) for p, s in leaves})
            _, args, shs = RS.make_prefill_fn(cfg, plan, b, seq)
            out[(name, arch, b, "prefill")] = [spec(s) for s in shs]
pickle.dump(out, open(OUT_PATH, "wb"))
"""


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_serve")
    src, dst = str(d / "in.pkl"), str(d / "out.pkl")
    with open(src, "wb") as f:
        pickle.dump((MESHES, ARCH_IDS, BATCHES, CACHE_LEN, SEQ), f)
    run_with_devices(_REF_CODE.replace("IN_PATH", repr(src))
                     .replace("OUT_PATH", repr(dst)), n_devices=8)
    with open(dst, "rb") as f:
        return pickle.load(f)


def _plan(name):
    shape, axes = MESHES[name]
    return SH.make_plan(LM.make_mesh(shape, axes,
                                     devices=["cpu"] * int(np.prod(shape))))


def _spec(s):
    return None if s is None else tuple(s.spec)


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shardings_match_reference(ref_specs, name, arch):
    plan = _plan(name)
    cfg = get_arch(arch).reduced()
    for b in BATCHES:
        _, _, cache, (ts, cs) = S.make_decode_fn(cfg, plan, b, CACHE_LEN)
        rts, rcs = ref_specs[(name, arch, b, "decode")]
        assert _spec(ts) == rts
        got = {k: _spec(s) for k, s in CV.tree_items(cs)}
        assert got == rcs, (arch, b)
        assert all(s.mesh is plan.mesh for _, s in CV.tree_items(cs))
        again = S.cache_shardings(cache, plan, batch_sharded=b == 4)
        assert {k: _spec(s) for k, s in CV.tree_items(again)} == rcs
        _, _, shs = S.make_prefill_fn(cfg, plan, b, SEQ)
        assert [_spec(s) for s in shs] == ref_specs[(name, arch, b,
                                                     "prefill")]


def test_shardings_without_a_mesh():
    cfg = get_arch("whisper-base").reduced()
    _, _, cache, (ts, cs) = S.make_decode_fn(cfg, ShardingPlan(None), 2, 8)
    assert ts is None
    # the cache's structure with None at every leaf
    assert cs == CV.map_tree(lambda _k, _leaf: None, cache)
    assert isinstance(cs["units"], list) and cs["units"][0]["b0"]["k"] is None
    _, _, shs = S.make_prefill_fn(cfg, ShardingPlan(None), 2, 8)
    assert shs == (None, None)


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in CV.tree_items(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_structs_match_reference_eval_shape(arch):
    rcfg, cfg = ref_arch(arch).reduced(), get_arch(arch).reduced()
    rplan, plan = RPlan(mesh=None), ShardingPlan(mesh=None)
    _, rtok, rcache, _ = RS.make_decode_fn(rcfg, rplan, 3, CACHE_LEN)
    fn, tok, cache, _ = S.make_decode_fn(cfg, plan, 3, CACHE_LEN)
    assert callable(fn)
    assert _shapes({"t": tok}) == _shapes({"t": rtok})
    assert _shapes(cache) == _shapes(rcache)
    assert all(v.device.type == "meta" for _, v in CV.tree_items(cache))
    _, rargs, _ = RS.make_prefill_fn(rcfg, rplan, 3, SEQ)
    _, args, _ = S.make_prefill_fn(cfg, plan, 3, SEQ)
    assert _shapes(args) == _shapes(rargs)
    assert _shapes(S.serving_params_struct(cfg)) == \
        _shapes(RS.serving_params_struct(rcfg))


# -- restore, paging and the whole slice on the CPU --------------------------------

def _u16(x):
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.cpu().view(torch.int16).numpy()
    x = np.asarray(x)
    assert str(x.dtype) == "bfloat16"
    return x.view(np.int16)


def _same_bits(got, ref):
    g, r = dict(CV.tree_items(got)), dict(CV.tree_items(ref))
    assert sorted(g) == sorted(r)
    for k in r:
        assert np.array_equal(_u16(g[k]), _u16(r[k])), k


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A reduced gemma3-1b saved by the reference (step 1) and its
    parameters saved by the port (another directory, step 3)."""
    rcfg = ref_arch("gemma3-1b").reduced()
    rp = jax.device_get(RT.init_params(jax.random.key(5), rcfg))
    d_ref = str(tmp_path_factory.mktemp("ref_ckpt"))
    d_port = str(tmp_path_factory.mktemp("port_ckpt"))
    RC.save_checkpoint(d_ref, rp, 1)
    flat = CV.tree_from_reference(rp, "cpu")
    port = CV.map_tree(lambda k, _v: flat[k], rp)
    C.save_checkpoint(d_port, port, 3, device="cpu")
    return rcfg, rp, d_ref, d_port


def test_restore_of_reference_checkpoint_matches_reference(ckpts):
    _, rp, d_ref, _ = ckpts
    ref, rmeta = RS.restore_serving_params(d_ref, RPlan(mesh=None))
    got, meta = S.restore_serving_params(d_ref, ShardingPlan(mesh=None),
                                         device="cpu")
    assert meta == rmeta == {"step": 1}
    assert isinstance(got["units"], list)
    assert all(v.device.type == "cpu" for _, v in CV.tree_items(got))
    _same_bits(got, ref)
    # lossy leaves really went through the codec (not a raw copy)
    wq = got["units"][0]["b0"]["attn"]["wq"].float().numpy()
    assert not np.array_equal(wq, rp["units"][0]["b0"]["attn"]["wq"])


def test_reference_restores_port_checkpoint(ckpts):
    _, _, _, d_port = ckpts
    ref, rmeta = RS.restore_serving_params(d_port, RPlan(mesh=None))
    got, meta = S.restore_serving_params(d_port, ShardingPlan(mesh=None),
                                         device="cpu")
    assert meta == rmeta == {"step": 3}
    _same_bits(got, ref)


def test_paged_and_mesh_restores_match_full(ckpts):
    _, _, d_ref, _ = ckpts
    full, _ = S.restore_serving_params(d_ref, ShardingPlan(mesh=None),
                                       device="cpu")
    one = SH.make_plan(LM.make_mesh((1, 1), ("data", "model"),
                                    devices=["cpu"]))
    store, meta = S.restore_serving_params(d_ref, one, paged=True,
                                           device="cpu", cache_bytes=1 << 20)
    assert meta == {"step": 1}
    with store, store.pin() as pin:
        _same_bits(pin.params(), full)
    placed, _ = S.restore_serving_params(d_ref, one, device="cpu")
    _same_bits(placed, full)
    # one process cannot drive a mesh whose positions name two devices
    # (serving over ranks: tests/test_torch_serve_dist.py)
    two = SH.make_plan(LM.make_mesh((2, 1), ("data", "model"),
                                    devices=["cuda:0", "cuda:1"]))
    with pytest.raises(ValueError, match="one process a position"):
        S.restore_serving_params(d_ref, two, device="cpu")


def _restore_across_packages(tmp_path, arch):
    """A reduced arch's checkpoint saved by each package restores through
    the other with the same bf16 bits; the port's init has the
    reference's leaves. -> the port's leaf paths and shapes."""
    rcfg = ref_arch(arch).reduced()
    rp = jax.device_get(RT.init_params(jax.random.key(7), rcfg))
    got = T.init_params(0, get_arch(arch).reduced(), device="cpu")
    assert _shapes(got) == _shapes(rp)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    RC.save_checkpoint(d_ref, rp, 1)
    flat = CV.tree_from_reference(rp, "cpu")
    C.save_checkpoint(d_port, CV.map_tree(lambda k, _v: flat[k], rp), 2,
                      device="cpu")
    for d, step in ((d_ref, 1), (d_port, 2)):
        ref, rmeta = RS.restore_serving_params(d, RPlan(mesh=None))
        port, meta = S.restore_serving_params(d, ShardingPlan(mesh=None),
                                              device="cpu")
        assert meta == rmeta == {"step": step}
        _same_bits(port, ref)
    return {k: tuple(v.shape) for k, v in CV.tree_items(got)}


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "phi3.5-moe-42b-a6.6b"])
def test_moe_mla_checkpoints_restore_across_packages(tmp_path, arch):
    """A reduced MoE arch's checkpoint (the 4-D stacked expert weights,
    the shared expert, the latent projections) saved by each package
    restores through the other with the same bf16 bits, and the port's
    init has the reference's leaves."""
    leaves = _restore_across_packages(tmp_path, arch)
    assert any(k.endswith("moe/wi") and len(s) == 4
               for k, s in leaves.items())


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_ssm_checkpoints_restore_across_packages(tmp_path, arch):
    """The same for the SSM archs: the ssm/ and ssm_cmix/ leaves (rwkv6's
    4-D lora_w2, mamba2's a_log), and zamba2's params['shared']."""
    leaves = _restore_across_packages(tmp_path, arch)
    assert any("/ssm/" in k for k in leaves)
    if arch == "zamba2-7b":
        assert any(k.startswith("shared/") for k in leaves)
        assert "units/0/b1/ssm/a_log" in leaves
    else:
        assert len(leaves["units/0/b0/ssm/lora_w2"]) == 4
        assert any("/ssm_cmix/" in k for k in leaves)


def test_restore_without_a_checkpoint(tmp_path, capsys):
    plan = ShardingPlan(mesh=None)
    assert S.restore_serving_params(str(tmp_path), plan, device="cpu") \
        is None
    assert S.paged_serving_store(str(tmp_path), plan, device="cpu") is None
    d = tmp_path / "step_00000002"
    d.mkdir()
    (d / "manifest.json").write_text('{"format": 1, "step": 2}')
    assert S.paged_serving_store(str(tmp_path), plan, device="cpu") is None
    assert "format-2" in capsys.readouterr().out


def test_serving_cast_per_leaf():
    cast = S._serving_cast(torch.bfloat16)
    f = cast("a", np.ones((3,), np.float32))
    assert isinstance(f, torch.Tensor) and f.dtype == torch.bfloat16
    i = cast("b", np.arange(3, dtype=np.int32))
    assert isinstance(i, np.ndarray) and i.dtype == np.int32
    b = torch.ones(2, dtype=torch.bfloat16)
    assert cast("c", b) is b
    assert cast("d", torch.ones(2, dtype=torch.float8_e4m3fn)).dtype == \
        torch.bfloat16


def test_served_requests_match_reference(ckpts):
    """Restore, prefill, a teacher-forced prompt of 20 tokens and 8 greedy
    tokens (the 16-slot rings wrap) through the port's callables and the
    reference's, on the same restored bf16 weights."""
    rcfg, _, d_ref, _ = ckpts
    cfg = get_arch("gemma3-1b").reduced()
    rparams, _ = RS.restore_serving_params(d_ref, RPlan(mesh=None))
    params, _ = S.restore_serving_params(d_ref, ShardingPlan(mesh=None),
                                         device="cpu")
    B, P_LEN, GEN = 2, 20, 8
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P_LEN)).astype(np.int32)
    rpre, _, _ = RS.make_prefill_fn(rcfg, RPlan(mesh=None), B, P_LEN)
    pre, _, _ = S.make_prefill_fn(cfg, ShardingPlan(mesh=None), B, P_LEN)
    want = rpre(rparams, jnp.asarray(prompt))
    got = pre(params, torch.from_numpy(prompt))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **LOGIT_TOL)
    rdec, _, _, _ = RS.make_decode_fn(rcfg, RPlan(mesh=None), B, CACHE_LEN)
    dec, _, _, _ = S.make_decode_fn(cfg, ShardingPlan(mesh=None), B,
                                    CACHE_LEN)
    rdec = jax.jit(rdec)
    rc = RT.init_cache(rcfg, B, CACHE_LEN)
    cache = T.init_cache(cfg, B, CACHE_LEN, device="cpu")
    tok = prompt[:, 0]
    for step in range(P_LEN + GEN):
        ref, rc = rdec(rparams, jnp.asarray(tok), rc)
        logits, cache = dec(params, torch.from_numpy(tok), cache)
        np.testing.assert_allclose(logits.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   err_msg=f"step {step}", **LOGIT_TOL)
        if step == P_LEN - 1:      # the prompt's last token: its prefill
            np.testing.assert_allclose(logits.float().numpy(),
                                       got.float().numpy(), **LOGIT_TOL)
        tok = prompt[:, step + 1] if step + 1 < P_LEN else \
            np.array(jnp.argmax(ref, -1), np.int32)
    assert cache["pos"].tolist() == [P_LEN + GEN] * B
