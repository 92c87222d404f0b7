"""The port's flash backward (``models/modules.py::_Flash``) and
``chunked_xent`` against the reference's, on the CPU.

The reference's flash attention is a ``jax.custom_vjp`` whose backward
recomputes every (bq, bk) score block (``src/repro/models/modules.py``
``_flash_bwd_rule``); the port's is a ``torch.autograd.Function`` doing
the same, rounding p and do, do and v, and ds * scale to bf16 where the
reference does, the products summed in f32. dq, dk and dv are held to
the reference's own flash-against-naive bound (rtol 3e-2, atol 8e-3,
``tests/test_models.py:121-122``) against ``jax.vjp`` of the reference
(they read 1e-5 to 1.3e-4 of each other in relative L2), over GQA, MQA,
Dv != D (MLA), sliding windows, a query offset, padded Sq and Sk and
several q and kv blocks, for f32 and bf16 inputs. Against a naive f32
attention under autograd they are held in relative L2 to 2^-7, one bf16
rounding (they read 0.0022-0.0038): element by element the bf16 dp
leaves a gradient where the exact one is 0 (a query that attends one
key has p = 1, and dp - delta rounds to ~0.01, not 0), and the
reference's own dq and dk read past the elementwise bound there too. A
saved-tensor hook shows that nothing of (Sq, Sk) per head is kept for
the backward.

``chunked_xent``: the value to rtol 1e-5 and the gradients of h and the
table to a relative L2 error of 2^-7 (one bf16 rounding) against
``jax.value_and_grad`` of the reference, with S not a multiple of the
chunk, with and without a softcap; under autograd no chunk's logits
outlive its forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import modules as RM
from repro.runtime.sharding import ShardingPlan as RPlan
from repro_torch.models import modules as M
from repro_torch.runtime.sharding import ShardingPlan

FLASH_TOL = dict(rtol=3e-2, atol=8e-3)
GRAD_REL = 2.0 ** -7

CASES = {
    # several q and kv blocks, GQA (G = 2), Sq and Sk padded
    "gqa": dict(S=300, H=8, K=4, D=16, causal=True, bq=64, bk=128),
    # MQA (gemma3-1b's K = 1) with a sliding window
    "mqa_window": dict(S=300, H=4, K=1, D=16, causal=True, window=40,
                       bq=64, bk=128),
    # Dv != D (MLA through mla_apply)
    "dv": dict(S=128, H=4, K=4, D=24, Dv=16, causal=True, bq=32, bk=64),
    # a query offset past a prefix (Sq < Sk)
    "q_offset": dict(S=96, H=4, K=2, D=16, causal=True, q_offset=50, Sq=40,
                     bq=16, bk=32),
    # cross attention over whisper-like frames: non-causal, Sk padded
    "cross": dict(S=150, H=4, K=4, D=16, causal=False, Sq=20, bq=16,
                  bk=64),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, dtype, seed):
    case = dict(case)
    S, H, K, D = (case.pop(n) for n in "SHKD")
    Sq, Dv = case.pop("Sq", S), case.pop("Dv", D)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((2, S, K, D)).astype(np.float32)
    v = rng.standard_normal((2, S, K, Dv)).astype(np.float32)
    do = rng.standard_normal((2, Sq, H, Dv)).astype(np.float32)
    # both packages take the same values: rounded to the input dtype
    cast = lambda x: np.asarray(jnp.asarray(x).astype(dtype)
                                .astype(jnp.float32))
    return [np.array(cast(x)) for x in (q, k, v, do)], case


def _port_grads(q, k, v, do, dtype, kw):
    t = [torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
         for x in (q, k, v)]
    out = M.flash_attention(*t, **kw)
    grads = torch.autograd.grad(out, t, torch.from_numpy(do).to(out.dtype))
    return out, grads


def _naive_grads(q, k, v, do, kw):
    """Softmax attention in f32 with the same positional mask, under
    autograd: the (Sq, Sk) scores whole."""
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    qq, kk, vv = t
    Sq, H, D = qq.shape[1:]
    Sk, K = kk.shape[1:3]
    G = H // K
    kr = kk.repeat_interleave(G, 2)
    vr = vv.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", qq, kr) * D ** -0.5
    qp = torch.arange(Sq)[:, None] + kw.get("q_offset", 0)
    kp = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if kw["causal"]:
        mask &= kp <= qp
    if kw.get("window"):
        mask &= kp > qp - kw["window"]
    s = torch.where(mask, s, torch.tensor(-1e30))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vr)
    return torch.autograd.grad(out, t, torch.from_numpy(do))


def _ref_grads(q, k, v, do, dtype, kw):
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: RM.flash_attention(a, b, c, **kw),
                       *args)
    return out, vjp(jnp.asarray(do).astype(out.dtype))


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rel(a, b):
    a, b = np.float64(_f32(a)), np.float64(_f32(b))
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_backward_matches_reference_and_naive(name, dtype):
    (q, k, v, do), kw = _inputs(CASES[name], dtype, seed=len(name))
    out, got = _port_grads(q, k, v, do, dtype, kw)
    rout, ref = _ref_grads(q, k, v, do, dtype, kw)
    np.testing.assert_allclose(_f32(out), _f32(rout), **FLASH_TOL)
    naive = _naive_grads(q, k, v, do, kw)
    for what, g, r, n, x in zip("qkv", got, ref, naive, (q, k, v)):
        assert g.dtype == getattr(torch, dtype) and g.shape == x.shape
        np.testing.assert_allclose(_f32(g), _f32(r), err_msg=f"d{what}",
                                   **FLASH_TOL)
        assert _rel(g, n) <= GRAD_REL, f"d{what} vs naive: {_rel(g, n)}"


def _saved_numels(fn):
    """numel of every tensor autograd saves while fn() runs."""
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sizes


def test_flash_backward_saves_nothing_of_sq_by_sk():
    B, S, H, D = 2, 256, 2, 8
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D))
                                .astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    kw = dict(causal=True, window=100, bq=64, bk=128)
    sizes = _saved_numels(lambda: M.flash_attention(q, k, v, **kw))
    # q, k, v, out (B S H D each) and lse (B H S)
    assert sizes and max(sizes) == B * S * H * D
    assert max(sizes) < B * S * S
    # the hook sees a naive attention's scores
    naive = _saved_numels(lambda: _naive_grads(
        *(x.detach().numpy() for x in (q, k, v)),
        np.ones((B, S, H, D), np.float32), dict(causal=True)))
    assert max(naive) >= B * H * S * S


def test_flash_backward_through_padding_only_reaches_real_rows():
    """Padded queries are sliced off and padded keys masked: gradients of
    the padding never reach the inputs (the pad's backward slices)."""
    (q, k, v, do), kw = _inputs(CASES["cross"], "float32", seed=9)
    _, (dq, dk, dv) = _port_grads(q, k, v, do, "float32", kw)
    assert dq.shape == q.shape and dk.shape == k.shape == (2, 150, 4, 16)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    assert dv.abs().sum(-1).gt(0).all()      # every real key is attended


# -- chunked_xent --------------------------------------------------------------------


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_xent_matches_reference(dtype, softcap):
    """S = 20 with chunk 8: the largest divisor at most 8 is 5, four
    chunks."""
    rng = np.random.default_rng(3)
    B, S, d, V = 2, 20, 32, 96
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    table = (rng.standard_normal((V, d)) * d ** -0.5).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    h = np.array(jnp.asarray(h).astype(dtype).astype(jnp.float32))

    def ref_fn(tab, hh):
        return RM.chunked_xent({"embed": {"table": tab}}, hh.astype(dtype),
                               jnp.asarray(labels), RPlan(mesh=None),
                               softcap=softcap, chunk=8)
    rv, (rgt, rgh) = jax.value_and_grad(ref_fn, argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(h))
    tab = torch.from_numpy(table).requires_grad_(True)
    hh = torch.from_numpy(h).requires_grad_(True)
    got = M.chunked_xent({"embed": {"table": tab}},
                         hh.to(getattr(torch, dtype)),
                         torch.from_numpy(labels), ShardingPlan(mesh=None),
                         softcap=softcap, chunk=8)
    gt, gh = torch.autograd.grad(got, (tab, hh))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(rv), rtol=1e-5)
    assert _rel(gt, rgt) <= GRAD_REL and _rel(gh, rgh) <= GRAD_REL
    # without grad: the same value, no checkpoint
    with torch.no_grad():
        again = M.chunked_xent({"embed": {"table": tab}},
                               hh.to(getattr(torch, dtype)),
                               torch.from_numpy(labels),
                               ShardingPlan(mesh=None), softcap=softcap,
                               chunk=8)
    assert torch.equal(again, got.detach())


def test_chunked_xent_keeps_no_chunk_logits():
    """Under autograd the chunks' logits are recomputed in the backward:
    nothing the size of one chunk's (B, chunk, V) logits is saved."""
    rng = np.random.default_rng(4)
    B, S, d, V = 2, 64, 16, 512
    tab = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32)
                           ).requires_grad_(True)
    h = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32)
                         ).requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, V, (B, S)))
    sizes = _saved_numels(lambda: M.chunked_xent(
        {"embed": {"table": tab}}, h, labels, ShardingPlan(mesh=None),
        chunk=16))
    assert max(sizes, default=0) < B * 16 * V
