"""The port's SSM blocks (``repro_torch/models/mamba2.py``,
``models/rwkv6.py``) against the reference's, on the CPU at reduced
sizes, the same numpy inputs (from this module's seeded ``rng``) and
the reference's parameters carried across.

Tolerances, and why:
  * bitwise: mamba2's deterministic leaves (``a_log`` is the reference's
    f32 log(linspace(1, 16, H)), XLA's linspace and log reproduced op by
    op; ``dt_bias``, ``d_skip``, the conv biases, rwkv6's
    ``decay_base``), the causal conv's new state, the cache inits, and
    both packages raising on a WKV length that is not a multiple of 16;
  * f32 functions without a scan (the causal conv, ``_mixes``, the
    channel mix): rtol 1e-5, atol 1e-6, a few f32 ulps of each matmul's
    sum and of XLA's tanh, logistic and exp against torch's;
  * the chunked scans ``ssd_chunked`` and ``_wkv_chunked``, held tighter
    than the models' bound, to bounds derived from their structure
    (``_ssd_bound``, ``_wkv_bound``; ROADMAP ground rules, "Sums of
    unknown order"): each output is a sum of products of factors that
    are positive decays times the inputs, so the same function on |x|,
    |B|, |C| (|r|, |k|, |v|, |u|) gives the mass M that every error is
    relative to;
  * the blocks (``mamba2_apply``/``decode``, ``rwkv6_apply``/``decode``)
    with the compute dtype f32: the models' bound (rtol 0.06, atol
    0.05, ``tests/test_models.py:83-85``), as the arch-level tests.
"""
import contextlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.configs import get_arch as ref_arch
from repro.models import mamba2 as RM2
from repro.models import modules as RMM
from repro.models import rwkv6 as RR6
from repro.models import transformer as RT
from repro.runtime.sharding import ShardingPlan as RPlan
from repro_torch import convert as CV
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as LM
from repro_torch.models import mamba2 as M2
from repro_torch.models import modules as M
from repro_torch.models import rwkv6 as R6
from repro_torch.models import transformer as T
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.sharding import ShardingPlan

RPLAN, PLAN = RPlan(mesh=None), ShardingPlan(mesh=None)
LOGIT_TOL = dict(rtol=0.06, atol=0.05)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
U = 2.0 ** -24                 # f32 unit roundoff
BF16_FLIP = 2.0 ** -7          # one bf16 ulp, relative, at most
SSM_ARCHS = ("rwkv6-1.6b", "zamba2-7b")


@pytest.fixture(scope="module")
def rng():
    """This module's own seeded generator: the session's (conftest.py)
    feeds other files' borderline bf16 cases, whose draws stay as they
    were."""
    return np.random.default_rng(27)


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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _same_scale(got, ref, k):
    """std within 10% of the reference's, or, for a small leaf, 3
    standard errors of the difference of two sample stds (3 / sqrt(n)
    relative)."""
    rs, gs = float(np.std(ref)), float(got.std())
    assert abs(gs - rs) <= max(0.1, 3 / np.sqrt(ref.size)) * rs, \
        (k, gs, rs)


def _port(rp):
    flat = CV.tree_from_reference(rp, "cpu")
    return CV.map_tree(lambda k, _v: flat[k], rp)


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32 if a.dtype.itemsize == 4 else np.int16)


@contextlib.contextmanager
def _f32():
    """Both packages' models with the compute dtype f32."""
    old = RMM.COMPUTE_DTYPE, M.COMPUTE_DTYPE
    RMM.COMPUTE_DTYPE, M.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        yield
    finally:
        RMM.COMPUTE_DTYPE, M.COMPUTE_DTYPE = old


def _tree_close(got, ref, tol, what):
    g, r = dict(CV.tree_items(got)), dict(CV.tree_items(jax.device_get(ref)))
    assert sorted(g) == sorted(r), what
    for k in r:
        assert str(g[k].dtype).replace("torch.", "") == str(r[k].dtype), k
        np.testing.assert_allclose(_np(g[k]), _np(r[k]),
                                   err_msg=f"{what} {k}", **tol)


# -- deterministic leaves -------------------------------------------------------

@pytest.mark.parametrize("H", [1, 2, 7, 32, 64, 112, 256, 352])
def test_a_log_is_the_reference_bitwise(H):
    got = M2.a_log_init(H, "cpu")
    ref = jnp.log(jnp.linspace(1.0, 16.0, H))
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got), _bits(ref))
    assert M2.a_log_init(H, "meta").shape == (H,)


def test_xla_log_bitwise_on_a_sample(rng):
    """The reproduced log against jnp.log on 2^16 f32 values in [1, 16]
    (checked over every f32 there when it was written) and the
    linspace against jnp.linspace."""
    x = np.sort(rng.uniform(1.0, 16.0, 1 << 16).astype(np.float32))
    x[:2] = (1.0, 16.0)
    assert np.array_equal(_bits(M2._xla_log(_t(x))), _bits(jnp.log(x)))
    for n in (3, 10, 100, 333):
        assert np.array_equal(_bits(M2._xla_linspace(1.0, 16.0, n, "cpu")),
                              _bits(jnp.linspace(1.0, 16.0, n)))


@pytest.mark.parametrize("d,G", [(64, 1), (128, 4)])
def test_mamba2_init_matches_reference(d, G):
    """Paths, shapes and per-leaf scale of the random leaves
    (``_same_scale``); the deterministic leaves bitwise."""
    cfg = M2.Mamba2Config(d_model=d, d_state=16, head_dim=16, n_groups=G)
    rcfg = RM2.Mamba2Config(d_model=d, d_state=16, head_dim=16, n_groups=G)
    assert repr(cfg) == repr(rcfg)
    ref = dict(CV.tree_items(jax.device_get(
        RM2.mamba2_init(jax.random.key(1), rcfg))))
    got = dict(CV.tree_items(M2.mamba2_init(
        torch.Generator().manual_seed(1), cfg)))
    meta = dict(CV.tree_items(M2.mamba2_init(None, cfg)))
    assert sorted(got) == sorted(ref) == sorted(meta)
    for k, r in ref.items():
        assert tuple(got[k].shape) == r.shape == tuple(meta[k].shape), k
        assert got[k].dtype == meta[k].dtype == torch.float32, k
        if k.split("/")[-1] in ("a_log", "dt_bias", "d_skip", "conv_x_b",
                                "convB_b", "convC_b", "scale"):
            assert np.array_equal(_bits(got[k]), _bits(r)), k
        else:
            _same_scale(got[k], r, k)


def test_rwkv6_init_matches_reference():
    cfg = R6.RWKV6Config(d_model=64, head_dim=16, d_ff=128)
    rcfg = RR6.RWKV6Config(d_model=64, head_dim=16, d_ff=128)
    assert repr(cfg) == repr(rcfg)
    key = jax.random.key(2)
    ref = {**RR6.rwkv6_init(key, rcfg), **RR6.rwkv6_cmix_init(key, rcfg)}
    ref = dict(CV.tree_items(jax.device_get(ref)))
    gen = torch.Generator().manual_seed(2)
    got = dict(CV.tree_items({**R6.rwkv6_init(gen, cfg),
                              **R6.rwkv6_cmix_init(gen, cfg)}))
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        assert tuple(got[k].shape) == r.shape, k
        if k.endswith(("decay_base", "scale")):
            assert np.array_equal(_bits(got[k]), _bits(r)), k
        else:
            _same_scale(got[k], r, k)


# -- mamba2 -----------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(rng, with_state):
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32) * 0.5
    b = rng.standard_normal(12).astype(np.float32) * 0.1
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    ry, rs = RM2._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if st is None else jnp.asarray(st))
    gy, gs = M2._causal_conv(_t(x), _t(w), _t(b),
                             None if st is None else _t(st))
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), **F32_TOL)
    assert np.array_equal(gs.numpy(), np.asarray(rs))


def test_segsum_matches_reference(rng):
    """out[i, j] = cs_i - cs_j: torch's cumsum and XLA's add in other
    orders, each partial sum within T u sum|a| of the exact one, so
    |out - ref| <= 2 T u (S_i + S_j), S the prefix sums of |a|; -inf above
    the diagonal exactly."""
    a = -np.abs(rng.standard_normal((2, 3, 64))).astype(np.float32) * 4
    ref, got = np.asarray(RM2._segsum(jnp.asarray(a))), \
        M2._segsum(_t(a)).numpy()
    upper = ~np.tril(np.ones((64, 64), bool))
    assert np.all(np.isneginf(got[..., upper]))
    assert np.all(np.isneginf(ref[..., upper]))
    S = np.cumsum(np.abs(a).astype(np.float64), -1)
    bound = 2 * 64 * U * (S[..., :, None] + S[..., None, :])
    low = ~upper
    assert np.all(np.abs(got[..., low] - ref[..., low]) <= bound[..., low])


def _ssd_inputs(rng, b, s, h, p, g, n, with_state):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_state else None
    return x, dt, a_log, B, C, st


def _ssd_bound(x, dt, a_log, B, C, st, chunk):
    """The bound on |port - reference| of ssd_chunked's y and final state.

    Every term of y is a product of up to three bf16-rounded factors
    (scores or C, L or the decays, x or the previous state) and f32
    decays; the packages' f32 pre-images of a factor differ (cumsum
    order, exp) by at most 2 T u S (S: the largest prefix sum of |dA| in
    a chunk) relative, and rounding to bf16 can then land one bf16 ulp
    apart (2^-7 relative at most). The scores are themselves a rounded
    sum: their mass is the sum of |C||B|. Through the state recurrence
    the previous state's own error adds the three factors of a state
    term, so a y_off term carries at most six such factors:
        |dy| <= 6 (2^-7 + 2 T u S) M,
    M the same scan on |x|, |B|, |C|, |state| without the bf16 rounding,
    widened by 2^-6 for it, plus (T + n) u M for the f32 sums."""
    T = chunk
    dA = -np.exp(a_log)[None, None] * dt
    pad = (-dA.shape[1]) % T
    dA = np.pad(dA, ((0, 0), (0, pad), (0, 0)))
    S = np.abs(dA).reshape(dA.shape[0], -1, T, dA.shape[2]).cumsum(2).max()
    eps = 6 * (BF16_FLIP + 2 * T * U * S) + (T + B.shape[-1]) * U
    old = M2._bf16
    M2._bf16 = lambda t: t
    try:
        my, mst = M2.ssd_chunked(
            _t(np.abs(x)).double(), _t(dt).double(), _t(a_log),
            _t(np.abs(B)).double(), _t(np.abs(C)).double(), T,
            None if st is None else _t(np.abs(st)).double())
    finally:
        M2._bf16 = old
    widen = 1 + 2.0 ** -6
    return eps * widen * my.numpy(), eps * widen * mst.double().numpy()


@pytest.mark.parametrize("s,h,g,chunk,with_state", [
    (32, 4, 1, 16, False),         # S a multiple of chunk, groups < heads
    (40, 4, 2, 16, False),         # the tail pad
    (37, 4, 4, 16, True),          # groups = heads, an initial state
    (24, 2, 1, 8, True),
])
def test_ssd_chunked_matches_reference(rng, s, h, g, chunk, with_state):
    x, dt, a_log, B, C, st = _ssd_inputs(rng, 2, s, h, 8, g, 8, with_state)
    ry, rs = RM2.ssd_chunked(jnp.asarray(x), jnp.asarray(dt),
                             jnp.asarray(a_log), jnp.asarray(B),
                             jnp.asarray(C), chunk,
                             None if st is None else jnp.asarray(st))
    gy, gs = M2.ssd_chunked(_t(x), _t(dt), _t(a_log), _t(B), _t(C), chunk,
                            None if st is None else _t(st))
    assert gy.shape == (2, s, h, 8) and gy.dtype == torch.float32
    assert gs.shape == (2, h, 8, 8) and gs.dtype == torch.float32
    by, bs = _ssd_bound(x, dt, a_log, B, C, st, chunk)
    assert np.all(np.abs(gy.numpy() - np.asarray(ry)) <= by)
    assert np.all(np.abs(gs.numpy() - np.asarray(rs)) <= bs)


def _mamba_cfgs(G=1):
    kw = dict(d_model=64, d_state=16, head_dim=16, n_groups=G, chunk=16)
    return RM2.Mamba2Config(**kw), M2.Mamba2Config(**kw)


@pytest.mark.parametrize("G,S", [(1, 40), (2, 16)])
def test_mamba2_apply_matches_reference(rng, G, S):
    rcfg, cfg = _mamba_cfgs(G)
    rp = jax.device_get(RM2.mamba2_init(jax.random.key(4), rcfg))
    rp["ssm"]["dt_bias"] = rng.standard_normal(cfg.n_heads).astype(
        np.float32) * 0.5
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    with _f32():
        ry, rs = RM2.mamba2_apply(rp, rcfg, jnp.asarray(x), RPLAN)
        gy, gs = M2.mamba2_apply(_port(rp), cfg, _t(x), PLAN)
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), **LOGIT_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), **LOGIT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_reference(rng, dtype):
    """Six steps from a random cache: the output and both cache leaves,
    their dtypes (conv in the compute dtype, state the cache's f32)."""
    rcfg, cfg = _mamba_cfgs(2)
    rp = jax.device_get(RM2.mamba2_init(jax.random.key(5), rcfg))
    p = _port(rp)
    cache = {"conv": rng.standard_normal((2, 3, 128 + 2 * 2 * 16)),
             "state": rng.standard_normal((2, cfg.n_heads, 16, 16))}
    rc = {"conv": jnp.asarray(cache["conv"], dtype),
          "state": jnp.asarray(cache["state"], jnp.float32)}
    gc = {"conv": _t(cache["conv"]).to(getattr(torch, dtype)),
          "state": _t(cache["state"]).float()}
    step = jax.jit(lambda p, x, c: RM2.mamba2_decode(p, rcfg, x, c, RPLAN))
    for i in range(6):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        ry, rc = step(rp, jnp.asarray(x, dtype), rc)
        gy, gc = M2.mamba2_decode(p, cfg, _t(x).to(getattr(torch, dtype)),
                                  gc, PLAN)
        np.testing.assert_allclose(_np(gy), _np(ry), err_msg=f"step {i}",
                                   **LOGIT_TOL)
        _tree_close(gc, rc, LOGIT_TOL, f"step {i}")
    assert gc["conv"].dtype == getattr(torch, dtype)
    assert gc["state"].dtype == torch.float32


def test_softplus_is_logaddexp():
    x = np.concatenate([np.linspace(-30, 30, 601),
                        [-np.inf, np.inf, 80.0]]).astype(np.float32)
    got = M2.softplus(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               **F32_TOL)


# -- rwkv6 ------------------------------------------------------------------------

def _rwkv(key=6, d=64, hd=16):
    rcfg = RR6.RWKV6Config(d_model=d, head_dim=hd, d_ff=128)
    cfg = R6.RWKV6Config(d_model=d, head_dim=hd, d_ff=128)
    k = jax.random.key(key)
    rp = jax.device_get({**RR6.rwkv6_init(k, rcfg),
                         **RR6.rwkv6_cmix_init(jax.random.fold_in(k, 1),
                                               rcfg)})
    return rcfg, cfg, rp, _port(rp)


@pytest.mark.parametrize("with_last", [False, True])
def test_mixes_match_reference(rng, with_last):
    _, _, rp, p = _rwkv()
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    last = rng.standard_normal((2, 64)).astype(np.float32) \
        if with_last else None
    ref = RR6._mixes(rp["ssm"], jnp.asarray(x),
                     None if last is None else jnp.asarray(last))
    got = R6._mixes(p["ssm"], _t(x), None if last is None else _t(last))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32_TOL)


def _wkv_inputs(rng, S, H=4, P=8):
    r, k, v = (rng.standard_normal((2, S, H, P)).astype(np.float32)
               for _ in range(3))
    logw = np.clip(-np.exp(rng.uniform(-8, 1, (2, S, H, P))),
                   R6.LOG_W_MIN, -1e-4).astype(np.float32)
    u = rng.standard_normal((H, P)).astype(np.float32) * 0.5
    return r, k, v, logw, u


def _wkv_bound(r, k, v, logw, u, st):
    """All f32. Each term is r k v times a positive decay exp(a_t - a_s)
    (exp(a_tot) across chunks); the packages' cumsums of the log decays
    (16 terms) differ by at most 16 u L each, L the largest |sum| of a
    chunk's |log w|, so a decay by at most 32 u L + 4 u (two cumsums,
    exp and the products) relative; the state carried over nc chunks
    adds one such factor a chunk:
        |dy| <= ((nc + 2) (32 L + 8) + 16 + P) u M,
    M the same scan on |r|, |k|, |v|, |u|, |state|."""
    S, P = r.shape[1], r.shape[-1]
    nc = S // R6.CHUNK
    L = np.abs(logw).reshape(2, nc, R6.CHUNK, *logw.shape[2:]).sum(2).max()
    eps = ((nc + 2) * (32 * L + 8) + 16 + P) * U
    my, ms = R6._wkv_chunked(*(_t(np.abs(a)) for a in (r, k, v)), _t(logw),
                             _t(np.abs(u)),
                             None if st is None else _t(np.abs(st)))
    return eps * my.numpy(), eps * ms.numpy()


@pytest.mark.parametrize("S,with_state", [(16, False), (48, True),
                                          (64, False)])
def test_wkv_chunked_matches_reference(rng, S, with_state):
    r, k, v, logw, u = _wkv_inputs(rng, S)
    st = rng.standard_normal((2, 4, 8, 8)).astype(np.float32) \
        if with_state else None
    ry, rs = RR6._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                              None if st is None else jnp.asarray(st))
    gy, gs = R6._wkv_chunked(*(_t(a) for a in (r, k, v, logw, u)),
                             None if st is None else _t(st))
    by, bs = _wkv_bound(r, k, v, logw, u, st)
    assert np.all(np.abs(gy.numpy() - np.asarray(ry)) <= by)
    assert np.all(np.abs(gs.numpy() - np.asarray(rs)) <= bs)


@pytest.mark.parametrize("S", [8, 20, 33])
def test_wkv_chunked_raises_off_a_multiple_of_16(rng, S):
    """The reference reshapes without padding and raises; so does the
    port, with no pad of its own."""
    a = _wkv_inputs(rng, S)
    with pytest.raises(TypeError):
        RR6._wkv_chunked(*(jnp.asarray(x) for x in a))
    with pytest.raises(ValueError, match="multiple of 16"):
        R6._wkv_chunked(*(_t(x) for x in a))


def test_rwkv6_apply_matches_reference(rng):
    rcfg, cfg, rp, p = _rwkv()
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    with _f32():
        ry, rs = RR6.rwkv6_apply(rp, rcfg, jnp.asarray(x), RPLAN)
        gy, gs = R6.rwkv6_apply(p, cfg, _t(x), PLAN)
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), **LOGIT_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), **LOGIT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_decode_matches_reference(rng, dtype):
    """Six steps from a random cache: output, sx (x's token, the compute
    dtype) and the f32 state."""
    rcfg, cfg, rp, p = _rwkv()
    dt = getattr(torch, dtype)
    sx = rng.standard_normal((2, 64)).astype(np.float32)
    st = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    rc = {"sx": jnp.asarray(sx, dtype), "state": jnp.asarray(st)}
    gc = {"sx": _t(sx).to(dt), "state": _t(st)}
    step = jax.jit(lambda p, x, c: RR6.rwkv6_decode(p, rcfg, x, c, RPLAN))
    for i in range(6):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        ry, rc = step(rp, jnp.asarray(x, dtype), rc)
        gy, gc = R6.rwkv6_decode(p, cfg, _t(x).to(dt), gc, PLAN)
        np.testing.assert_allclose(_np(gy), _np(ry), err_msg=f"step {i}",
                                   **LOGIT_TOL)
        _tree_close(gc, rc, LOGIT_TOL, f"step {i}")
    assert gc["sx"].dtype == dt and gc["state"].dtype == torch.float32


@pytest.mark.parametrize("with_last", [False, True])
def test_rwkv6_cmix_matches_reference(rng, with_last):
    rcfg, cfg, rp, p = _rwkv()
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    last = rng.standard_normal((2, 64)).astype(np.float32) \
        if with_last else None
    ry, rl = RR6.rwkv6_cmix_apply(rp, rcfg, jnp.asarray(x), RPLAN,
                                  None if last is None else jnp.asarray(last))
    gy, gl = R6.rwkv6_cmix_apply(p, cfg, _t(x), PLAN,
                                 None if last is None else _t(last))
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), **F32_TOL)
    assert np.array_equal(gl.numpy(), np.asarray(rl))


# -- caches -----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cache_inits_match_reference(dtype):
    rm, m = _mamba_cfgs(2)
    rr, r = RR6.RWKV6Config(64, 16, d_ff=128), R6.RWKV6Config(64, 16, d_ff=128)
    for ref, got in ((RM2.mamba2_cache_init(rm, 3, jnp.dtype(dtype)),
                      M2.mamba2_cache_init(m, 3, getattr(torch, dtype),
                                           "cpu")),
                     (RR6.rwkv6_cache_init(rr, 3, jnp.dtype(dtype)),
                      R6.rwkv6_cache_init(r, 3, getattr(torch, dtype),
                                          "cpu"))):
        ref = dict(CV.tree_items(jax.device_get(ref)))
        got = dict(CV.tree_items(got))
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in ref.items()}
        assert all(not v.any() for v in got.values())
    lead = M2.mamba2_cache_init(m, 3, device="meta", lead=(5,))
    assert lead["conv"].shape == (5, 3, 3, 192) and \
        lead["state"].shape == (5, 3, 8, 16, 16)


def test_zamba2_caches_and_shared_params_match_reference():
    """zamba2's per-insertion KV caches of its shared block (units[1],
    the remainder unit, included) and params['shared'] against the
    reference's init_cache and init_params."""
    rcfg, cfg = ref_arch("zamba2-7b").reduced(), get_arch("zamba2-7b").reduced()
    ref = dict(CV.tree_items(jax.device_get(RT.init_cache(rcfg, 2, 24))))
    got = dict(CV.tree_items(T.init_cache(cfg, 2, 24, device="cpu")))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert [len(u.blocks) for u in cfg.units] == [3, 2]
    assert tuple(got["units/1/b0/k"].shape) == (1, 2, 24, 4, 16)
    assert tuple(got["units/1/b1/state"].shape) == (1, 2, 2, 64, 16)
    meta = dict(CV.tree_items(T.init_params(0, cfg, device="meta")))
    rmeta = jax.eval_shape(lambda k: RT.init_params(k, rcfg),
                           jax.random.key(0))
    rmeta = dict(CV.tree_items(rmeta))
    assert {k: tuple(v.shape) for k, v in meta.items()} == \
        {k: v.shape for k, v in rmeta.items()}
    assert any(k.startswith("shared/attn/") for k in meta)
    assert not any(k.startswith("units/0/b0/") for k in meta)
    full = T.init_cache(get_arch("zamba2-7b").config(), 2, 64, device="meta")
    assert [u["b0"]["k"].shape[0] for u in full["units"]] == [13, 1]
    assert len(full["units"][1]) == 4


# -- rules, counts, checkpoints ----------------------------------------------

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


def test_param_rules_match_reference_on_ssm_and_shared_leaves(tmp_path):
    """Every ssm/, ssm_cmix/ and shared/ leaf of both archs, at reduced
    and published shapes, takes the reference's spec on (2,2) and
    (2,2,2)."""
    meshes = {"2x2": ((2, 2), ("data", "model")),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
    leaves = []
    for arch in SSM_ARCHS:
        for cfg in (get_arch(arch).reduced(), get_arch(arch).config()):
            for k, v in CV.tree_items(T.init_params(0, cfg, device="meta")):
                if "ssm/" in k or "ssm_cmix/" in k or k.startswith("shared/"):
                    leaves.append((k, tuple(v.shape)))
    for part in ("ssm/wi_z", "ssm/conv_x_b", "ssm/a_log", "ssm/lora_w2",
                 "ssm_cmix/wv", "shared/attn/wq", "shared/mlp/wg"):
        assert any(part in k for k, _ in leaves), part
    assert any(k.endswith("lora_w2") and len(s) == 4 for k, s in leaves)
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


def test_published_ssm_configs_count_their_parameters():
    """The meta trees of the published configs hold the reference's
    parameter counts (``eval_shape``)."""
    want = {"zamba2-7b": 6_636_442_832, "rwkv6-1.6b": 1_465_501_696}
    for a, n in want.items():
        tree = T.init_params(0, get_arch(a).config(), device="meta")
        got = sum(v.numel() for _, v in CV.tree_items(tree))
        ref = jax.eval_shape(lambda k: RT.init_params(k, ref_arch(a).config()),
                             jax.random.key(0))
        assert got == n == sum(int(np.prod(x.shape))
                               for x in jax.tree.leaves(ref)), a
    tree = dict(CV.tree_items(T.init_params(
        0, get_arch("rwkv6-1.6b").config(), device="meta")))
    assert tuple(tree["units/0/b0/ssm/lora_w2"].shape) == (24, 5, 32, 2048)
    tree = dict(CV.tree_items(T.init_params(
        0, get_arch("zamba2-7b").config(), device="meta")))
    assert tuple(tree["units/0/b1/ssm/wi_x"].shape) == (13, 3584, 7168)
    assert tuple(tree["shared/mlp/wi"].shape) == (3584, 14336)
