"""The port's models (``repro_torch/models/modules.py``,
``models/transformer.py``, ``configs/``) against the reference's, on the
CPU, at the ``get_reduced()`` sizes of all ten archs: the six attention
archs, deepseek-v2 (MLA and MoE), phi3.5-moe, zamba2 (mamba2 and a
shared attention block) and rwkv6.

``jax.random`` cannot be reproduced in torch, so every model case carries
the reference's parameters across (``port_params``: the flat
``convert.tree_from_reference`` put back in the reference's nesting) and
feeds both packages the same numpy inputs.

Tolerances, and why the arithmetic is not bitwise: the rope
frequencies, ``masked_cache_write`` and the ring's slot map and mask
are held bitwise. The rest computes in bf16, where XLA on the CPU
keeps f32 between the fused elementwise ops of a chain (and its sin,
cos, rsqrt and reduction orders are its own) while eager torch rounds
after every op; such a difference is an ulp of a bf16 value, and it
moves the next matmul's inputs. So:
  * norm_apply and apply_rope/apply_mrope on f32 inputs: within 4 f32
    ulps (rtol 5e-7, atol 1e-6), the reference's rsqrt, sin and cos
    against torch's;
  * flash_attention on f32 inputs: no looser than the reference's own
    flash-against-naive bound (rtol 3e-2, atol 8e-3,
    ``tests/test_models.py:121-122``);
  * logits of serve_prefill and of every serve_decode step: the
    reference's own bound for decode against prefill (rtol 0.06, atol
    0.05, ``tests/test_models.py:83-85``), a few bf16 ulps of a logit.
    The SSM archs are held in f32 on both sides (PREFILL_DTYPE,
    DECODE_DTYPE): in bf16 the reference's own prefill run op by op
    reads 1.16 (zamba2) and 2.91 (rwkv6) of the bound against its
    compiled prefill (``tools/bf16_fullwidth_check.py --arch <arch>
    --reduced --prompt 32``; ROADMAP Queue 3). Their blocks are held in
    ``tests/test_torch_ssm.py``.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import modules as RM
from repro.models import transformer as RT
from repro.runtime.sharding import ShardingPlan as RPlan
from repro_torch import convert as CV
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import modules as M
from repro_torch.models import transformer as T
from repro_torch.runtime.sharding import ShardingPlan

RPLAN, PLAN = RPlan(mesh=None), ShardingPlan(mesh=None)
ARCH_IDS = sorted(ARCHS)
LOGIT_TOL = dict(rtol=0.06, atol=0.05)
FLASH_TOL = dict(rtol=3e-2, atol=8e-3)
F32_TOL = dict(rtol=5e-7, atol=1e-6)
DECODE_STEPS = 24          # past the reduced gemma3 window of 16
SSM_ARCHS = ("rwkv6-1.6b", "zamba2-7b")
# the compute dtype of the prefill and decode parity cases (bf16 unless
# named)
PREFILL_DTYPE = {a: "float32" for a in SSM_ARCHS}
DECODE_DTYPE = {"deepseek-v2-236b": "float32",
                "phi3.5-moe-42b-a6.6b": "float32", **PREFILL_DTYPE}
# prompt lengths: rwkv6's chunked WKV needs a multiple of 16, as the
# reference's (its raise: tests/test_torch_ssm.py)
PROMPT_LEN = {"rwkv6-1.6b": 32}
# each arch's reference key: the eight archs before the SSM ones keep
# theirs (10 + their index among themselves), the SSM archs come after
KEYS = {a: 10 + i for i, a in enumerate(
    [a for a in ARCH_IDS if a not in SSM_ARCHS] + list(SSM_ARCHS))}
# leaves the reference fills by a rule, not a draw: held bitwise
DETERMINISTIC = ("a_log", "dt_bias", "d_skip", "decay_base", "conv_x_b",
                 "convB_b", "convC_b")


def _draws(rng, arch):
    """The SSM archs' cases draw from a generator of their own, so the
    session's draws for the other archs' cases stay as they were."""
    return np.random.default_rng(KEYS[arch]) if arch in SSM_ARCHS else rng
CACHE_LEN = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module's small arrays: the suite runs
    its files in parallel workers, and timing tests share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in CV.tree_items(tree)}


# -- building blocks ------------------------------------------------------------

@pytest.mark.parametrize("layernorm", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_apply_matches_reference(rng, layernorm, dtype):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(64).astype(np.float32) * 0.1}
    if layernorm:
        p["bias"] = rng.standard_normal(64).astype(np.float32) * 0.1
    rx = jnp.asarray(x).astype(dtype)
    ref = RM.norm_apply({k: jnp.asarray(v) for k, v in p.items()}, rx)
    got = M.norm_apply({k: _t(v) for k, v in p.items()},
                       _t(x).to(getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{dtype}"
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(ref), **F32_TOL)
    else:       # one bf16 rounding of values within 4 f32 ulps
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=2 ** -7)


@pytest.mark.parametrize("rd", [None, 16])
def test_rope_matches_reference(rng, rd):
    D, theta = 32, 10_000.0
    ref_inv = RM.rope_freqs(D, theta, rd)
    inv = M.rope_freqs(D, theta, rd)
    assert inv.dtype == torch.float32
    assert np.array_equal(inv.numpy(), np.asarray(ref_inv))
    x = rng.standard_normal((2, 40, 3, D)).astype(np.float32)
    pos = np.arange(40)[None, :] + np.array([[0], [700]])
    ref = RM.apply_rope(jnp.asarray(x), jnp.asarray(pos), ref_inv, rd)
    got = M.apply_rope(_t(x), _t(pos), inv, rd)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("B", [1, 2, 4])
def test_mrope_matches_reference(rng, B):
    """Prefill positions (3, B, S), and decode's (B, 1), whose rows the
    reference takes as the three streams (a static index past B clamps)."""
    D, secs = 16, (3, 3, 2)
    inv = M.rope_freqs(D, 1e6)
    ref_inv = RM.rope_freqs(D, 1e6)
    x = rng.standard_normal((B, 6, 2, D)).astype(np.float32)
    pos3 = rng.integers(0, 1000, (3, B, 6))
    ref = RM.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), ref_inv, secs)
    got = M.apply_mrope(_t(x), _t(pos3), inv, secs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    x1 = x[:, :1]
    pos = np.full((B, 1), 37)
    ref = RM.apply_mrope(jnp.asarray(x1), jnp.asarray(pos), ref_inv, secs)
    got = M.apply_mrope(_t(x1), _t(pos), inv, secs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_masked_cache_write_and_ring_update_bitwise(rng):
    B, L, K, D = 3, 8, 2, 4
    cache = rng.standard_normal((B, L, K, D)).astype(np.float32)
    rc, pc = jnp.asarray(cache, jnp.bfloat16), _t(cache).to(torch.bfloat16)
    for step in range(20):
        new = rng.standard_normal((B, 1, K, D)).astype(np.float32)
        pos = np.array([step, step + 3, 2 * step], np.int32)
        rc = RT._ring_update(rc, jnp.asarray(new), jnp.asarray(pos))
        pc = T._ring_update(pc, _t(new), _t(pos))
        assert np.array_equal(np.asarray(rc).view(np.int16),
                              pc.view(torch.int16).numpy())
    slot = np.array([0, 7, 3], np.int32)
    new = rng.standard_normal((B, 1, K, D)).astype(np.float32)
    ref = RM.masked_cache_write(jnp.asarray(cache), jnp.asarray(new),
                                jnp.asarray(slot))
    got = M.masked_cache_write(_t(cache), _t(new), _t(slot))
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("L,window", [(8, 8), (8, 5), (16, 16)])
def test_ring_slot_map(L, window):
    """Slot s holds the newest global position g <= pos with g % L == s;
    it is attended iff 0 <= g and g > pos - window."""
    for p in range(3 * L + 2):
        pos = torch.tensor([p, max(p - 3, 0)])
        g, valid = T._ring_slots(pos, L, window)
        for b, pb in enumerate(pos.tolist()):
            for s in range(L):
                want = pb - ((pb - s) % L)
                assert int(g[b, s]) == want
                assert bool(valid[b, s]) == (want >= 0 and want > pb - window)


def _naive(q, k, v, mask):
    H, K, D = q.shape[2], k.shape[2], q.shape[3]
    kr, vr = np.repeat(k, H // K, 2), np.repeat(v, H // K, 2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kr) * D ** -0.5
    s = np.where(mask[None, None], s, -1e38)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", w, vr)


@pytest.mark.parametrize("case", [
    dict(S=300, H=8, K=4, D=16, causal=True, bq=64, bk=128),
    dict(S=256, H=2, K=2, D=8, causal=True, window=32, bq=64, bk=64),
    dict(S=300, H=4, K=1, D=16, causal=True, window=40, bq=64, bk=128),
    dict(S=96, H=4, K=2, D=16, causal=True, q_offset=50, Sq=40, bq=16,
         bk=32),
    dict(S=150, H=4, K=4, D=16, causal=False, Sq=7),
])
def test_flash_attention_matches_reference(rng, case):
    case = dict(case)
    S, H, K, D = (case.pop(n) for n in "SHKD")
    Sq = case.pop("Sq", S)
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((2, S, K, D)).astype(np.float32)
    v = rng.standard_normal((2, S, K, D)).astype(np.float32)
    ref = RM.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **case)
    got = M.flash_attention(_t(q), _t(k), _t(v), **case)
    assert got.shape == (2, Sq, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLASH_TOL)
    qp = np.arange(Sq)[:, None] + case.get("q_offset", 0)
    kp = np.arange(S)[None, :]
    mask = np.ones((Sq, S), bool)
    if case["causal"]:
        mask &= kp <= qp
    if case.get("window"):
        mask &= kp > qp - case["window"]
    np.testing.assert_allclose(got.numpy(), _naive(q, k, v, mask),
                               **FLASH_TOL)


def test_flash_fully_masked_rows_stay_finite(rng):
    """A query row with no key in its window softmaxes to uniform weights,
    as the reference's finite NEG_INF makes it."""
    q = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    kw = dict(causal=True, window=1, q_offset=-4, bq=4, bk=4)
    got = M.flash_attention(_t(q), _t(k), _t(v), **kw)
    ref = RM.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FLASH_TOL)


# -- configs, params, caches  --------------------------------------------------------

def port_params(rp):
    """The reference's parameter tree as the port's: the same nesting,
    the flat dict's tensors at the leaves."""
    flat = CV.tree_from_reference(rp, "cpu")
    return CV.map_tree(lambda k, _v: flat[k], rp)


@pytest.fixture(scope="module")
def models():
    """{arch: (reference cfg, its params, port cfg, the same params)}."""
    out = {}
    for arch in ARCH_IDS:
        rcfg = ref_arch(arch).reduced()
        rp = jax.device_get(RT.init_params(jax.random.key(KEYS[arch]), rcfg))
        out[arch] = (rcfg, rp, get_arch(arch).reduced(),
                     port_params(rp))
    return out


def test_registry_matches_reference():
    from repro.configs import ARCHS as RARCHS
    assert set(ARCHS) == set(RARCHS)
    for a in ARCH_IDS:
        spec, rspec = get_arch(a), ref_arch(a)
        assert (spec.family, spec.source, spec.shapes) == \
            (rspec.family, rspec.source, tuple(
                type(spec.shapes[0])(**dataclasses.asdict(s))
                for s in rspec.shapes))
        for fn in ("config", "reduced"):
            assert repr(getattr(spec, fn)()) == repr(getattr(rspec, fn)())
    with pytest.raises(KeyError):
        get_arch("gpt-5")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_matches_reference(models, arch):
    """Same paths, shapes, dtypes and per-leaf scale (std within 10% over
    the leaf; for the SSM archs' leaves of n < 900 values 3 standard
    errors of the difference of two sample stds, 3 / sqrt(n), where that
    is wider; zero leaves exactly zero;
    the SSM leaves filled by a rule, DETERMINISTIC, bitwise), and the
    meta tree the same."""
    _, ref, cfg, _ = models[arch]
    got = T.init_params(0, cfg, device="cpu")
    meta = T.init_params(0, cfg, device="meta")
    want = _shapes(ref)
    assert _shapes(got) == want and _shapes(meta) == want
    assert all(v.device.type == "meta" for _, v in CV.tree_items(meta))
    r = dict(CV.tree_items(ref))
    for k, v in CV.tree_items(got):
        if k.rsplit("/", 1)[-1] in DETERMINISTIC:
            assert np.array_equal(v.numpy(), r[k]), k
            continue
        rs, gs = float(np.std(r[k])), float(v.std())
        if rs == 0:
            assert not v.any(), k
        else:       # the SSM archs' small leaves: 3 standard errors of
            # the difference of two sample stds where that is wider
            tol = max(0.1, 3 / np.sqrt(v.numel())) if arch in SSM_ARCHS \
                else 0.1
            assert abs(gs - rs) <= tol * rs, (k, gs, rs)
    again = T.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    assert all(torch.equal(v, dict(CV.tree_items(again))[k])
               for k, v in CV.tree_items(got))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_matches_reference(arch):
    ref = RT.init_cache(ref_arch(arch).reduced(), 3, 24)
    got = T.init_cache(get_arch(arch).reduced(), 3, 24, device="cpu")
    assert _shapes(got) == _shapes(jax.device_get(ref))
    assert all(not v.any() for _, v in CV.tree_items(got))


def test_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_arch("gemma3-1b").reduced()
    for fn in (lambda: T.init_params(0, cfg),
               lambda: T.init_cache(cfg, 2, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


# -- prefill and decode -----------------------------------------------------------

def _inputs(cfg, rng, B=2, S=20):
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fe = None
    if cfg.frontend == "audio":
        fe = rng.standard_normal((B, cfg.encoder.n_frames, cfg.d_model))
    elif cfg.frontend == "vision":
        fe = rng.standard_normal((B, cfg.frontend_len, cfg.d_model))
    return toks, None if fe is None else fe.astype(np.float32)


def _assert_logits(got, ref, what, dtype="bfloat16"):
    assert got.dtype == getattr(torch, dtype), what
    assert torch.isfinite(got).all(), what
    np.testing.assert_allclose(_f32(got), _f32(ref), err_msg=what,
                               **LOGIT_TOL)


def test_nested_params_carry_across(models):
    _, rp, _, params = models["gemma3-1b"]
    assert isinstance(params["units"], list)
    assert params["units"][0]["b0"]["attn"]["wq"].shape == \
        rp["units"][0]["b0"]["attn"]["wq"].shape
    back = CV.tree_to_reference(params, like=rp)
    for (k, a), (k2, b) in zip(CV.tree_items(back), CV.tree_items(rp)):
        assert k == k2 and a.dtype == b.dtype
        assert np.array_equal(a, b), k


@contextlib.contextmanager
def _compute_dtype(dtype):
    """Both packages' models with their compute dtype set to `dtype`."""
    old = RM.COMPUTE_DTYPE, M.COMPUTE_DTYPE
    RM.COMPUTE_DTYPE, M.COMPUTE_DTYPE = jnp.dtype(dtype), getattr(torch,
                                                                  dtype)
    try:
        yield
    finally:
        RM.COMPUTE_DTYPE, M.COMPUTE_DTYPE = old


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_prefill_matches_reference(models, rng, arch):
    """Whisper with its audio frontend (the encoder, cross-attention over
    16 frames), qwen2-vl with its vision prefix; the SSM archs in f32
    (PREFILL_DTYPE)."""
    rcfg, rp, cfg, params = models[arch]
    toks, fe = _inputs(cfg, _draws(rng, arch), S=PROMPT_LEN.get(arch, 20))
    dtype = PREFILL_DTYPE.get(arch, "bfloat16")
    with _compute_dtype(dtype):
        ref = RT.serve_prefill(rp, rcfg, jnp.asarray(toks), RPLAN,
                               frontend=None if fe is None
                               else jnp.asarray(fe))
        got = T.serve_prefill(params, cfg, _t(toks), PLAN,
                              frontend=None if fe is None else _t(fe))
    assert got.shape == (2, cfg.vocab_size)
    _assert_logits(got, ref, arch, dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_decode_matches_reference(models, rng, arch):
    """24 decode steps into a 32-slot cache (the reduced gemma3 local
    layers' 16-slot rings wrap), the tokens the reference's greedy
    choices: logits within the bound at every step, pos the same.

    The MoE and SSM archs decode in f32 on both sides (DECODE_DTYPE;
    the SSM archs' reason: the module docstring). The MoE archs' bf16
    router logits meet near-ties that one bf16 ulp upstream flips, and
    a flipped expert moves a token's logits far past the bound. The
    reference's own bf16 decode does not hold its bound against itself
    there: jitted against eager, the reduced deepseek reads 8.10 of it
    at one of 24 steps and phi3.5 4.70 and 2.92 at two
    (``tools/bf16_fullwidth_check.py --moe-decode``).
    Their bf16 prefill is held below, and their routing bitwise in
    ``tests/test_torch_moe_mla.py``."""
    rcfg, rp, cfg, params = models[arch]
    B = 2
    dtype = DECODE_DTYPE.get(arch, "bfloat16")
    with _compute_dtype(dtype):
        rstep = jax.jit(lambda p, t, c: RT.serve_decode(p, rcfg, t, c,
                                                        RPLAN))
        rc = RT.init_cache(rcfg, B, CACHE_LEN, jnp.dtype(dtype))
        cache = T.init_cache(cfg, B, CACHE_LEN, getattr(torch, dtype),
                             device="cpu")
        tok = _draws(rng, arch).integers(0, cfg.vocab_size,
                                         (B,)).astype(np.int32)
        for step in range(DECODE_STEPS):
            ref, rc = rstep(rp, jnp.asarray(tok), rc)
            got, cache = T.serve_decode(params, cfg, _t(tok), cache, PLAN)
            _assert_logits(got, ref, f"{arch} step {step}", dtype)
            tok = np.asarray(jnp.argmax(ref, -1), np.int32)
    assert cache["pos"].dtype == torch.int32
    assert cache["pos"].tolist() == np.asarray(rc["pos"]).tolist() \
        == [DECODE_STEPS] * B
    assert _shapes(cache) == _shapes(jax.device_get(rc))


@pytest.mark.parametrize("arch", ["glm4-9b", "gemma3-1b", "rwkv6-1.6b"])
def test_decode_matches_prefill(models, rng, arch):
    """The port's teacher-forced decode reproduces its prefill's last
    logits (KV cache and, for gemma3, a ring past its window; rwkv6's
    token shifts and WKV state against its chunked scan). zamba2 is not
    held so: the reference's own bf16 teacher-forced decode reads 1.19
    of the bound against its prefill (``tools/bf16_fullwidth_check.py
    --arch zamba2-7b --reduced --prompt 32``; ROADMAP Queue 3)."""
    _, _, cfg, params = models[arch]
    toks, _ = _inputs(cfg, _draws(rng, arch), S=PROMPT_LEN.get(arch, 21))
    full = T.serve_prefill(params, cfg, _t(toks), PLAN)
    cache = T.init_cache(cfg, 2, 64, device="cpu")
    for t in range(toks.shape[1]):
        logits, cache = T.serve_decode(params, cfg, _t(toks[:, t]), cache,
                                       PLAN)
    np.testing.assert_allclose(_f32(logits), _f32(full), **LOGIT_TOL)


def test_decode_leaves_its_cache_alone(models):
    _, _, cfg, params = models["gemma3-4b"]
    cache = T.init_cache(cfg, 2, 8, device="cpu")
    before = {k: v.clone() for k, v in CV.tree_items(cache)}
    _, new = T.serve_decode(params, cfg, torch.tensor([1, 2]), cache, PLAN)
    assert all(torch.equal(v, before[k]) for k, v in CV.tree_items(cache))
    assert any(not torch.equal(v, before[k])
               for k, v in CV.tree_items(new) if k != "pos")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decode_leaves_its_cache_alone(models, arch):
    """The SSM states (conv, state, sx, sx_cmix) come back as new tensors
    with new values; the input cache keeps its values."""
    _, _, cfg, params = models[arch]
    cache = T.init_cache(cfg, 2, 8, device="cpu")
    before = {k: v.clone() for k, v in CV.tree_items(cache)}
    ptrs = {v.data_ptr() for _, v in CV.tree_items(cache)}
    _, new = T.serve_decode(params, cfg, torch.tensor([1, 2]), cache, PLAN)
    assert all(torch.equal(v, before[k]) for k, v in CV.tree_items(cache))
    ssm = {k: v for k, v in CV.tree_items(new)
           if k.rsplit("/", 1)[-1] in ("conv", "state", "sx", "sx_cmix")}
    assert ssm and all(v.data_ptr() not in ptrs for v in ssm.values())
    assert all(not torch.equal(v, before[k]) for k, v in ssm.items())
