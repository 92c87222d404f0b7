"""The port's training loss (``models/transformer.py::lm_loss``) and its
gradients against the reference's ``jax.grad``, on the CPU, at every
arch's ``get_reduced()`` size.

Both packages take the reference's parameters (``convert.
tree_from_reference``) and a ``data/synthetic.py`` batch, and compute
in f32 (``COMPUTE_DTYPE`` patched on both sides, as
``tests/test_torch_models.py`` does for its f32 cases): the loss, its
xent and aux within rtol 1e-5, every gradient leaf within a relative L2
error of 2^-7. That is one bf16 rounding: both sides still round to bf16
explicitly inside the flash backward and mamba2's ``ssd_chunked``.

zamba2-7b is held with ``ssd_chunked``'s explicit bf16 switched to f32
on both sides (the reference's module-level ``jnp`` seen through a
namespace whose ``bfloat16`` is f32, the port's ``_bf16`` the identity):
with it, the reference's own gradients move by up to 0.027 in relative
L2 when its params move by one f32 ulp, so no bound of one bf16
rounding can hold between two implementations (ROADMAP Queue 3;
``python3 tools/grad_parity.py --arch zamba2-7b`` prints both
readings).

The MoE's capacity buffer passes gradients through kept pairs only (an
overfull expert's dropped tokens get none from y), its gradients in f32
against the reference's on exactly representable inputs.

Then, port only: remat 'block' gives the same gradient bits as 'none';
the bf16 counterparts of the reference's ``test_smoke_forward_loss``
(the loss of a random init within (0.5 ln V, 3 ln V)) and
``test_smoke_grad_step`` (finite gradients of norm > 0).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.models import mamba2 as RM2
from repro.models import modules as RM
from repro.models import transformer as RT
from repro.runtime.sharding import ShardingPlan as RPlan
from repro_torch import convert as CV
from repro_torch.configs import ARCHS, get_arch
from repro_torch.data.synthetic import DataConfig, batch_for_step
from repro_torch.models import mamba2 as M2
from repro_torch.models import modules as M
from repro_torch.models import transformer as T
from repro_torch.runtime.sharding import ShardingPlan

ARCH_IDS = sorted(ARCHS)
PLAN, RPLAN = ShardingPlan(mesh=None), RPlan(mesh=None)
LOSS_RTOL = 1e-5
GRAD_REL = 2.0 ** -7
# the archs held with ssd_chunked's explicit bf16 in f32 on both sides
SSD_F32 = ("zamba2-7b",)
SEQ = 32


class _JnpF32(types.ModuleType):
    """jax.numpy with ``bfloat16`` standing for float32."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def f32_compute(arch, monkeypatch):
    """Both packages' models in f32 for the test; for SSD_F32 also
    ssd_chunked."""
    monkeypatch.setattr(RM, "COMPUTE_DTYPE", jnp.dtype("float32"))
    monkeypatch.setattr(M, "COMPUTE_DTYPE", torch.float32)
    if arch in SSD_F32:
        monkeypatch.setattr(RM2, "jnp", _JnpF32("jax.numpy"))
        monkeypatch.setattr(M2, "_bf16", lambda t: t.float())


def data_config(cfg, batch=2, seq=SEQ, seed=0):
    """The training driver's DataConfig for `cfg` (a vision prefix takes
    its frontend_len of the sequence)."""
    text = seq - (cfg.frontend_len if cfg.frontend == "vision" else 0)
    return DataConfig(
        vocab_size=cfg.vocab_size, global_batch=batch, seq_len=text,
        seed=seed, frontend=cfg.frontend,
        frontend_len=(cfg.encoder.n_frames if cfg.encoder
                      else cfg.frontend_len),
        frontend_dim=cfg.d_model)


def port_grads(params, cfg, batch):
    """(loss, metrics, {path: grad}) of lm_loss over params' leaves."""
    flat = dict(CV.tree_items(params))
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in flat.items()}
    loss, metr = T.lm_loss(CV.map_tree(lambda k, _v: leaves[k], params),
                           cfg, batch, PLAN)
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metr.items()}, {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(leaves.items(), got)}


def rel_l2(got, want):
    a = np.float64(got.float().numpy() if isinstance(got, torch.Tensor)
                   else np.asarray(got, np.float32))
    b = np.float64(np.asarray(want, np.float32))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def ref_params():
    """{arch: the reference's reduced params (numpy)}."""
    return {a: jax.device_get(RT.init_params(jax.random.key(20 + i),
                                             ref_arch(a).reduced()))
            for i, a in enumerate(ARCH_IDS)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_and_grads_match_reference(arch, ref_params, monkeypatch):
    rcfg, cfg = ref_arch(arch).reduced(), get_arch(arch).reduced()
    rp = ref_params[arch]
    batch = batch_for_step(data_config(cfg, seed=ARCH_IDS.index(arch)), 0)
    f32_compute(arch, monkeypatch)
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, b: RT.lm_loss(p, rcfg, b, RPLAN), has_aux=True))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    flat = CV.tree_from_reference(rp, "cpu")
    loss, metr, grads = port_grads(
        CV.map_tree(lambda k, _v: flat[k], rp), cfg,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    np.testing.assert_allclose(float(loss), float(rl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metr["xent"]), float(rm["xent"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metr["aux"]), float(rm["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    ref = dict(CV.tree_items(jax.device_get(rg)))
    assert set(ref) == set(grads)
    worst = max((rel_l2(g, ref[k]), k) for k, g in grads.items())
    assert worst[0] <= GRAD_REL, worst


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_block_remat_gives_the_same_gradient_bits(arch):
    cfg = get_arch(arch).reduced()
    assert cfg.remat == "block"
    params = T.init_params(1, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             batch_for_step(data_config(cfg, seed=5), 0).items()}
    with_remat = port_grads(params, cfg, batch)
    without = port_grads(params, dataclasses.replace(cfg, remat="none"),
                         batch)
    assert torch.equal(with_remat[0], without[0])
    for k, g in with_remat[2].items():
        assert torch.equal(g, without[2][k]), k


def test_block_remat_saves_one_input_a_repeat():
    """Under remat 'block' the forward keeps only each repeat's inputs for
    the backward: far fewer saved values than without."""
    cfg = get_arch("gemma3-1b").reduced()
    params = CV.map_tree(lambda _k, v: v.requires_grad_(True),
                         T.init_params(2, cfg, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in
             batch_for_step(data_config(cfg, seed=6), 0).items()}

    def saved(c):
        n = [0]

        def pack(t):
            n[0] += t.numel()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            T.forward_hidden(params, c, batch["tokens"], PLAN)
        return n[0]
    assert saved(cfg) * 3 < saved(dataclasses.replace(cfg, remat="none"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_loss_and_grad_step(arch):
    """The reference's test_smoke_forward_loss and test_smoke_grad_step in
    the port, bf16: the loss of a random init near ln V, the gradients
    finite with a norm above 0."""
    cfg = get_arch(arch).reduced()
    params = T.init_params(0, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             batch_for_step(data_config(cfg, seed=7), 0).items()}
    loss, _, grads = port_grads(params, cfg, batch)
    assert np.isfinite(float(loss))
    assert 0.5 * np.log(cfg.vocab_size) < float(loss) \
        < 3.0 * np.log(cfg.vocab_size)
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert sum(float((g.double() ** 2).sum()) for g in grads.values()) > 0


def test_moe_gradients_pass_through_kept_pairs_only():
    """The MoE's index writes (the capacity buffer and its dump slot) pass
    gradients to the tokens through their kept pairs only: with an
    overfull expert, a token whose pairs all drop gets no gradient from
    y, and the gradients of x, the router and the experts match the
    reference's ``jax.grad`` in f32 (exactly representable inputs)."""
    rng = np.random.default_rng(11)
    T, d, f, E, k = 48, 16, 24, 8, 2
    q = lambda *s: (rng.integers(-8, 9, s) / 8.0).astype(np.float32)
    p = {"router": q(d, E), "wi": q(E, d, f), "wg": q(E, d, f),
         "wo": q(E, f, d)}
    p["router"][:, 5] += 1.0                       # expert 5 overflows
    x = (rng.integers(-1, 2, (T, d)) / 2.0).astype(np.float32)
    w = q(T, d)
    cfg = dict(d_model=d, d_ff=f, n_experts=E, top_k=k)
    cap = M._moe_capacity(T, M.MoEConfig(**cfg), E)

    def ref_loss(xx, pp):
        y, aux = RM.moe_local_math(xx, pp, RM.MoEConfig(**cfg), 0, E, cap)
        return jnp.sum(y * w) + aux
    rgx, rgp = jax.grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(x), {kk: jnp.asarray(v) for kk, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {kk: torch.from_numpy(v).requires_grad_(True) for kk, v in p.items()}
    y, aux = M.moe_local_math(tx, tp, M.MoEConfig(**cfg), 0, E, cap)
    gx, *gp = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                                  [tx] + list(tp.values()))
    assert rel_l2(gx, rgx) <= GRAD_REL
    for (kk, _), g in zip(tp.items(), gp):
        assert rel_l2(g, rgp[kk]) <= GRAD_REL, kk
    r = M.moe_route(torch.softmax(torch.from_numpy(x @ p["router"]), -1), k,
                    0, E, cap)
    kept = torch.zeros(T, dtype=torch.bool)
    kept[r["st"][r["valid"]]] = True
    assert int(r["counts"].max()) > cap and not kept.all()
    gy, = torch.autograd.grad((M.moe_local_math(
        tx, tp, M.MoEConfig(**cfg), 0, E, cap)[0]
        * torch.from_numpy(w)).sum(), [tx])
    assert not gy[~kept].any() and gy[kept].abs().sum() > 0
