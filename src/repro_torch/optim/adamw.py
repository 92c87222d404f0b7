"""AdamW over a dict of tensors with reduced-precision moments.

The port of ``src/repro/optim/adamw.py``: f32 master params, bf16 moments
by default, global-norm clipping and a linear warm-up. Trees are
``dict[str, Tensor]`` in the reference's leaf order
(``convert.tree_from_reference``), so :func:`global_norm` sums the
per-leaf f32 sums of squares in that order, from 0, as the reference's
Python ``sum`` over ``jax.tree.leaves`` does. Each leaf's own sum is
blocked in two levels, so its error has a bound (:func:`norm_error`) that
does not depend on the order ``torch.sum`` takes on the card.

Every step is plain PyTorch, op by op as the reference writes it, each op
rounded once. Two evaluations still differ in the last bits: the order
inside each leaf's f32 sum of squares (XLA's, the card's and the CPU's
reductions differ), ``pow`` in the bias corrections, and XLA's
contraction of multiply-adds into FMAs on the CPU. :func:`step_deviation`
bounds what that can do to one step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..runtime.fused import target_device

Tree = Dict[str, torch.Tensor]
U32 = 2.0 ** -24                 # f32 unit roundoff


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.bfloat16
    warmup_steps: int = 100


def adamw_init(params: Tree, cfg: AdamWConfig, device="cuda") -> Dict:
    dev = target_device(device)
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=dev)
    return {"mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    return cfg.lr * warm


def sqrt_block(n: int) -> int:
    """The block of a two-level sum or scan of n values: a power of two
    within a factor sqrt(2) of sqrt(n), so that a term takes about
    2*sqrt(n) roundings at most."""
    return 1 << (n.bit_length() // 2)


def _leaf_square_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum of squares of x: the sums of blocks of sqrt_block(n) values,
    then the sum of those."""
    sq = torch.square(x.to(torch.float32)).reshape(-1)
    b = sqrt_block(sq.numel())
    sq = torch.nn.functional.pad(sq, (0, (-sq.numel()) % b))
    return sq.reshape(-1, b).sum(dim=1).sum()


def global_norm(tree: Tree) -> torch.Tensor:
    total = 0
    for x in tree.values():
        total = total + _leaf_square_sum(x)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _scalars(grads: Tree, step: torch.Tensor, cfg: AdamWConfig,
             grad_norm=None):
    gn = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    sf = step.to(torch.float32)
    return dict(gn=gn, clip=clip, lr=_schedule(cfg, step),
                bc1=1 - cfg.b1 ** sf, bc2=1 - cfg.b2 ** sf)


def adamw_update(params: Tree, grads: Tree, opt_state: Dict,
                 cfg: AdamWConfig, device="cuda", grad_norm=None
                 ) -> Tuple[Tree, Dict, Dict]:
    """One step -> (params, opt state, {"grad_norm", "lr"}). Runs on
    ``device`` (the card unless ``device='cpu'``). `grad_norm`: the
    global norm of the whole gradients when `params`, `grads` and the
    moments are one rank's shards of them (the update is elementwise
    given the norm: a shard's update is the slice of the whole one's);
    by default :func:`global_norm` of `grads`."""
    dev = target_device(device)
    step = opt_state["step"].to(dev) + 1
    if grad_norm is not None:
        grad_norm = grad_norm.to(dev)
    s = _scalars({k: g.to(dev) for k, g in grads.items()}, step, cfg,
                 grad_norm)
    b1, b2 = cfg.b1, cfg.b2
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        p, mu, nu = p.to(dev), opt_state["mu"][k].to(dev), \
            opt_state["nu"][k].to(dev)
        g = grads[k].to(dev).to(torch.float32) * s["clip"]
        mu32 = b1 * mu.to(torch.float32) + (1 - b1) * g
        nu32 = b2 * nu.to(torch.float32) + (1 - b2) * g * g
        mhat = mu32 / s["bc1"]
        vhat = nu32 / s["bc2"]
        p32 = p.to(torch.float32)
        upd = p32 - s["lr"] * (mhat / (torch.sqrt(vhat) + cfg.eps)
                               + cfg.weight_decay * p32)
        new_p[k] = upd.to(p.dtype)
        new_mu[k] = mu32.to(mu.dtype)
        new_nu[k] = nu32.to(nu.dtype)
    return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, \
        {"grad_norm": s["gn"], "lr": s["lr"]}


def _pow_err(b: float, step: int) -> float:
    """Relative error bound of bc = 1 - b**step in f32: pow within 2 ulps
    (CUDA's powf bound; the CPU's libm and XLA's are tighter), amplified by
    the cancellation b^s / (1 - b^s), plus the subtraction's rounding."""
    bs = b ** step
    return 4 * U32 * bs / (1 - bs) + U32


def step_deviation(p, g, mu, nu, step: int, cfg: AdamWConfig, clip: float,
                   rho: float) -> Dict[str, torch.Tensor]:
    """Per-element bounds (float64) on how far two evaluations of one
    AdamW step from the same inputs can lie apart, when each one's clip
    factor lies within the relative amount ``rho`` of the exact one and
    each rounds every f32 operation (with or without FMA contraction)
    once.

    p, g, mu, nu: one leaf's inputs (any device); step: the step being
    taken (1-based); clip: the exact clip factor (:func:`clip_factor` of
    the float64 norm),
    each evaluation's within ``rho`` of it (:func:`clip_rho`). Returns
    {"p": bound on |p'_A - p'_B|, "mu", "nu": bounds on the f32 moments
    before their bf16 cast, "mu32", "nu32": those moments, exact}. Each
    bound is the sum of the two evaluations' forward-error bounds against
    the exact step with that clip c (first order in the unit roundoff
    u = 2^-24):

      G = g c;    |G~ - G|   <= |G| (rho + u)
      M = b1 mu + (1-b1) G;  |M~ - M| <= 3u (b1|mu| + (1-b1)|G|)
                                        + (1-b1)|G| (rho + u)
      V = b2 nu + (1-b2) G^2 (no cancellation):  |V~ - V| <= V (6u + 2 rho)
      m = M / bc1, v = V / bc2, bc within _pow_err
      U = m / (sqrt(v) + eps): |U~ - U| <= |m~ - m| / D + |U| (ev/2 + 3u)
      P' = p - lr (U + wd p): |P'~ - P'| <= lr (|U~ - U| + 6u(|U| + wd|p|))
                                           + u |P'|

    with ev the relative error of v and lr's own rounding (3u) inside the
    6u. bf16 inputs are exact in f32, and a contracted FMA rounds less.
    """
    d = dict(dtype=torch.float64)
    p, g, mu, nu = (t.to(**d) for t in (p, g, mu, nu))
    b1, b2, u = cfg.b1, cfg.b2, U32
    a1, a2 = 1 - b1, 1 - b2
    sf = float(step)
    lr = cfg.lr * min(sf / max(cfg.warmup_steps, 1), 1.0)
    bc1, bc2 = 1 - b1 ** sf, 1 - b2 ** sf
    e1, e2 = _pow_err(b1, step), _pow_err(b2, step)
    G = g.abs() * clip
    M = b1 * mu + a1 * g * clip
    S_M = b1 * mu.abs() + a1 * G
    dM = 3 * u * S_M + a1 * G * (rho + u)
    V = b2 * nu + a2 * G * G
    dV = V * (6 * u + 2 * rho)
    m = M / bc1
    dm = dM / bc1 + m.abs() * (e1 + u)
    v = V / bc2
    ev = 6 * u + 2 * rho + e2 + u
    D = torch.sqrt(v) + cfg.eps
    U = m / D
    dU = dm / D + U.abs() * (ev / 2 + 3 * u)
    P = p - lr * (U + cfg.weight_decay * p)
    dP = lr * (dU + 6 * u * (U.abs() + cfg.weight_decay * p.abs())) \
        + u * P.abs()
    # two evaluations, each within the bound of the exact step
    return {"p": 2 * dP, "mu": 2 * dM, "nu": 2 * dV, "mu32": M, "nu32": V}


def norm_error(tree: Tree, blocked: bool = True) -> Tuple[float, float]:
    """-> (the float64 global norm, a bound on |gn - it| for an f32
    evaluation gn of the norm).

    Every term of the f32 sum of squares is a square (one rounding) that
    takes at most d more roundings on its way into the total: with
    ``blocked``, the port's :func:`global_norm`, d = (B - 1) + (n/B - 1)
    inside a leaf of n values in blocks of B, whatever order ``torch.sum``
    takes in each level, plus L - 1 across the L leaves; else (the
    reference's XLA sums, order unknown) d = N - 1 over all N values. The
    terms are non-negative, so the sum is within g = (1 + u)^(d+1) - 1 of
    the exact one relative to it; the square root within g / (2 - g), then
    rounded once. The float64 norm's own error (N * 2^-53) is added."""
    L = len(tree)
    N = sum(x.numel() for x in tree.values())
    if blocked:
        d = max((sqrt_block(x.numel()) - 1
                 + -(-x.numel() // sqrt_block(x.numel())) - 1
                 for x in tree.values()), default=0) + L - 1
    else:
        d = N - 1
    exact = math.sqrt(sum(float(torch.sum(torch.square(
        x.to(torch.float64)))) for x in tree.values()))
    g = math.expm1((d + 1) * math.log1p(U32))
    rel = g / (2 - g) * (1 + U32) + U32 + N * 2.0 ** -53
    return exact, rel * exact


def clip_factor(gn: float, cfg: AdamWConfig) -> float:
    """The clip factor of global norm gn, in float64."""
    return min(1.0, cfg.grad_clip / max(gn, 1e-9))


def clip_rho(exact: float, norms, cfg: AdamWConfig) -> float:
    """Relative distance from the exact clip factor (float64 norm
    ``exact``) of the clips that evaluations take from their f32 norms
    ``norms`` (each first held within :func:`norm_error` of ``exact``),
    plus the f32 rounding of grad_clip and of the division."""
    c = clip_factor(exact, cfg)
    return max(abs(clip_factor(gn, cfg) - c) for gn in norms) / c \
        + 2 * U32


def bf16_moment_check(m32_exact: torch.Tensor, bound: torch.Tensor,
                      a: torch.Tensor, b: torch.Tensor) -> Tuple[int, bool]:
    """Compare two bf16 moments a, b, each the bf16 rounding of an f32
    value within ``bound`` of ``m32_exact`` (float64) -> (number of
    elements where a and b differ, whether each such a and b lies within
    bound plus half a bf16 ulp of the exact value). Away from a bf16
    rounding boundary the two round alike; under cancellation the bound
    can span several bf16 values."""
    diff = a.view(torch.int16) != b.view(torch.int16)
    n = int(diff.sum())
    if n == 0:
        return 0, True
    x, bd = m32_exact[diff], bound[diff]

    def within(v):
        v = v[diff].to(torch.float64)
        _, e = torch.frexp(v)
        half_ulp = torch.ldexp(torch.ones_like(v), e - 9).clamp(
            min=2.0 ** -134)
        return (v - x).abs() <= bd + half_ulp
    return n, bool((within(a) & within(b)).all())
