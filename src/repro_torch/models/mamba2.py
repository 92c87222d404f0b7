"""Mamba-2 (SSD) block of the port (``src/repro/models/mamba2.py``):
chunked-scan prefill and recurrent decode, plain functions over the
reference's parameter tree.

Used by zamba2-7b's SSM layers. The minimal SSD formulation (Dao & Gu
2024): within chunks a masked quadratic form, across chunks a linear
state recurrence run as a sequential loop over the chunks.

``ssd_chunked`` keeps the reference's explicit bf16 whatever the compute
dtype: the decay matrix L, the scores and the inputs of its three
contractions are rounded to bf16. Each product is formed on f32 copies
of the rounded values (a product of two bf16 values is exact in f32)
and summed in f32, as the reference's ``preferred_element_type`` asks;
the scores are rounded to bf16 once, after their f32 sum. So no
contraction accumulates in bf16 on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..runtime.sharding import ShardingPlan
from .modules import _normal, dense_init, key_device, norm_apply, norm_init


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


# -- the reference's f32 linspace and log, bit for bit ---------------------------

def _fma32(a, b, c):
    """f32 fused multiply-add: the product of two f32 values is exact in
    f64, so one f64 add rounded to f32 gives the fused result."""
    return (a.double() * b.double() + c.double()).float()


def _xla_linspace(start: float, stop: float, num: int, device):
    """``jnp.linspace(start, stop, num)`` in f32 as XLA compiles it on
    the CPU: step = iota * f32(1/(num-1)), start * (1 - step) plus iota *
    f32(stop / (num-1)) contracted into one FMA, the endpoint appended.
    Held bitwise for num <= 352 (tests/test_torch_ssm.py); the reference
    compiles larger sizes otherwise."""
    s = torch.tensor(start, dtype=torch.float32, device=device)
    e = torch.tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return s.reshape(1)
    c = torch.tensor(1.0, dtype=torch.float32, device=device) / (num - 1)
    io = torch.arange(num - 1, dtype=torch.float32, device=device)
    a = s * (1.0 - io * c)
    out = _fma32(io, e * c, a)
    return torch.cat([out, e.reshape(1)])


# the Cephes polynomial of XLA's CPU log
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _xla_log(x):
    """``jnp.log`` of positive normal f32 `x` as XLA's CPU backend
    computes it (the Cephes polynomial, its multiply-adds fused; held
    bitwise over every f32 in [1, 16] against the reference)."""
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    bits = x.float().view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < f(0.707106781186547524)
    tmp = torch.where(small, m, f(0.0))
    m = m - 1.0
    e = e - small.float()
    m = m + tmp
    x2 = m * m
    x3 = x2 * m
    p = [f(v) for v in _LOG_P]
    y = _fma32(m, p[0], p[1])
    y1 = _fma32(m, p[3], p[4])
    y2 = _fma32(m, p[6], p[7])
    y = _fma32(y, m, p[2])
    y1 = _fma32(y1, m, p[5])
    y2 = _fma32(y2, m, p[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, e * f(-2.12194440e-4))
    m = _fma32(x2, f(-0.5), m)
    m = m + y
    return _fma32(e, f(0.693359375), m)


def a_log_init(n_heads: int, device):
    """log(linspace(1, 16, H)), the reference's bits (not random)."""
    if torch.device(device).type == "meta":
        return torch.empty((n_heads,), dtype=torch.float32, device="meta")
    return _xla_log(_xla_linspace(1.0, 16.0, n_heads, device))


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    (``F.softplus`` returns x itself past its threshold of 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


# -- init ---------------------------------------------------------------------------

def mamba2_init(key, cfg: Mamba2Config):
    """Separate projections per segment, as the reference (z/x shard over
    model; the small B/C/dt streams stay replicated)."""
    dev = key_device(key)
    di, H, N, G = cfg.d_inner, cfg.n_heads, cfg.d_state, cfg.n_groups
    K = cfg.conv_kernel
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    p = {
        "wi_z": dense_init(key, cfg.d_model, (di,)),
        "wi_x": dense_init(key, cfg.d_model, (di,)),
        "wi_B": dense_init(key, cfg.d_model, (G * N,)),
        "wi_C": dense_init(key, cfg.d_model, (G * N,)),
        "wi_dt": dense_init(key, cfg.d_model, (H,)),
        "conv_x_w": _normal(key, (K, di), K ** -0.5),
        "conv_x_b": zeros(di),
        "convB_w": _normal(key, (K, G * N), K ** -0.5),
        "convB_b": zeros(G * N),
        "convC_w": _normal(key, (K, G * N), K ** -0.5),
        "convC_b": zeros(G * N),
        "a_log": a_log_init(H, dev),
        "dt_bias": zeros(H),
        "d_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm": norm_init(di, device=dev),
        "wo": _normal(key, (di, cfg.d_model), di ** -0.5),
    }
    return {"ssm": p}


# -- prefill --------------------------------------------------------------------------

def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq. x: (B,S,C); w: (K,C).

    With `state` ((B, K-1, C), decode) it is the left context; returns
    (silu(conv), the new state: the last K-1 inputs)."""
    K = w.shape[0]
    if state is None:
        xp = torch.cat([torch.zeros_like(x[:, :K - 1]), x], 1)
    else:
        xp = torch.cat([state.to(x.dtype), x], 1)
    S = x.shape[1]
    out = 0
    for i in range(K):                    # the reference's python sum
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out + b), xp[:, -(K - 1):]


def _segsum(a):
    """Cumulative segment sums: out[..., i, j] = sum_{k=j+1..i} a[..., k]."""
    T = a.shape[-1]
    cs = torch.cumsum(a, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -torch.inf)


def _bf16(t):
    """`t` rounded to bf16, held in f32."""
    return t.to(torch.bfloat16).float()


def ssd_chunked(x, dt, a_log, B, C, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """SSD scan. x: (b,s,h,p); dt: (b,s,h) f32; B,C: (b,s,g,n).

    Returns (y (b,s,h,p) in x's dtype, final_state (b,h,p,n) f32). The
    contractions in the reference's order: the scores (C.B over n, rounded
    to bf16), then y_diag = (scores * L) . x over m; states = x . (decay
    * B) over l; y_off = (C * in_decay) . prev over n."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    s_real = s
    pad = (-s) % chunk
    if pad:       # zero-pad tail: zero x contributes nothing to states/y
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s += pad
    nc = s // chunk
    A = -torch.exp(a_log.float())                            # (h,) negative
    dA = dt * A                                              # (b,s,h)
    xd = x * dt[..., None].to(x.dtype)

    rs = lambda t: t.reshape((b, nc, chunk) + tuple(t.shape[2:]))
    xc, dAc, Bc, Cc = rs(xd), rs(dA), rs(B), rs(C)
    rep = h // g                  # broadcast groups to heads (jnp.repeat)
    Bh = Bc.repeat_interleave(rep, dim=3) if g != h else Bc  # (b,nc,l,h,n)
    Ch = Cc.repeat_interleave(rep, dim=3) if g != h else Cc
    Bb, Cb, xb = _bf16(Bh), _bf16(Ch), _bf16(xc)

    dAc = dAc.permute(0, 1, 3, 2)                            # (b,nc,h,l)
    L = _bf16(torch.exp(_segsum(dAc)))                       # (b,nc,h,l,l)
    # intra-chunk (diagonal blocks)
    scores = _bf16(torch.einsum("bclhn,bcmhn->bchlm", Cb, Bb))
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", scores * L, xb)
    # chunk states
    dA_tot = dAc.sum(-1)                                     # (b,nc,h)
    decay = torch.exp(dA_tot[..., None] - torch.cumsum(dAc, -1))  # (b,nc,h,l)
    db = _bf16(decay).permute(0, 1, 3, 2)[..., None] * Bb    # (b,nc,l,h,n)
    states = torch.einsum("bclhp,bclhn->bchpn", xb, db)
    # inter-chunk recurrence: sequential over the chunks, each step
    # emitting the state before it
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(dA_tot[:, c])[:, :, None, None] \
            + states[:, c]
    prev_states = torch.stack(prev, 1)                       # (b,nc,h,p,n)
    # inter-chunk contribution
    in_decay = torch.exp(torch.cumsum(dAc, -1))              # (b,nc,h,l)
    cd = Cb.permute(0, 1, 3, 2, 4) * _bf16(in_decay)[..., None]  # (b,nc,h,l,n)
    y_off = torch.einsum("bchln,bchpn->bclhp", cd, _bf16(prev_states))
    y = (y_diag + y_off).reshape(b, s, h, p).to(x.dtype)
    return y[:, :s_real], carry


def _in_proj(sp, x):
    dt_ = x.dtype
    return tuple(torch.einsum("btd,de->bte", x, sp[k].to(dt_))
                 for k in ("wi_z", "wi_x", "wi_B", "wi_C", "wi_dt"))


def mamba2_apply(p, cfg: Mamba2Config, x, plan: ShardingPlan):
    """Prefill. x: (B,S,d) -> (y, final_ssm_state)."""
    sp = p["ssm"]
    dt_ = x.dtype
    B_, S, _ = x.shape
    di, H, N, G, P_ = (cfg.d_inner, cfg.n_heads, cfg.d_state, cfg.n_groups,
                       cfg.head_dim)
    z, xin, Bm, Cm, dt = _in_proj(sp, x)
    z = plan.act_btf(z)
    xin = plan.act_btf(xin)
    xin, _ = _causal_conv(xin, sp["conv_x_w"].to(dt_),
                          sp["conv_x_b"].to(dt_))
    xin = plan.act_btf(xin)
    Bm, _ = _causal_conv(Bm, sp["convB_w"].to(dt_), sp["convB_b"].to(dt_))
    Cm, _ = _causal_conv(Cm, sp["convC_w"].to(dt_), sp["convC_b"].to(dt_))
    dt = softplus(dt.float() + sp["dt_bias"])
    y, state = ssd_chunked(xin.reshape(B_, S, H, P_), dt, sp["a_log"],
                           Bm.reshape(B_, S, G, N), Cm.reshape(B_, S, G, N),
                           cfg.chunk)
    y = y + xin.reshape(B_, S, H, P_) * sp["d_skip"][:, None].to(dt_)
    y = y.reshape(B_, S, di)
    y = norm_apply(sp["norm"], y) * F.silu(z)
    out = torch.einsum("bte,ed->btd", y, sp["wo"].to(dt_))
    return plan.act_btd(out), state


# -- decode -------------------------------------------------------------------------

def mamba2_decode(p, cfg: Mamba2Config, x, cache, plan: ShardingPlan):
    """Single-token step. cache: {'conv': (B,K-1,di+2GN), 'state':
    (B,H,P,N)}; x: (B,1,d). One conv over the concatenated [x, B, C]
    with the concatenated weights. The new cache's tensors are new:
    `conv` in the compute dtype, `state` in the cache's."""
    sp = p["ssm"]
    dt_ = x.dtype
    B_ = x.shape[0]
    di, H, N, G, P_ = (cfg.d_inner, cfg.n_heads, cfg.d_state, cfg.n_groups,
                       cfg.head_dim)
    z, xi, Bi, Ci, dt = _in_proj(sp, x)
    conv_in = torch.cat([xi, Bi, Ci], -1)
    conv_w = torch.cat([sp["conv_x_w"], sp["convB_w"],
                        sp["convC_w"]], -1).to(dt_)
    conv_b = torch.cat([sp["conv_x_b"], sp["convB_b"],
                        sp["convC_b"]], -1).to(dt_)
    xbc, conv_state = _causal_conv(conv_in, conv_w, conv_b, cache["conv"])
    xin, Bm, Cm = torch.split(xbc[:, 0], [di, G * N, G * N], -1)
    dt1 = softplus(dt[:, 0].float() + sp["dt_bias"])
    A = -torch.exp(sp["a_log"].float())
    dA = torch.exp(dt1 * A)                                  # (B,H)
    xh = xin.reshape(B_, H, P_)
    Bh = Bm.reshape(B_, G, N).repeat_interleave(H // G, 1)
    Ch = Cm.reshape(B_, G, N).repeat_interleave(H // G, 1)
    st = cache["state"].float()
    # the reference's einsum "bhp,bhn,bh->bhpn": (x * dt) first, then B
    xdt = xh.float() * dt1[:, :, None]
    st = st * dA[:, :, None, None] + xdt[..., None] * Bh.float()[:, :, None]
    y = torch.einsum("bhpn,bhn->bhp", st, Ch.float()).to(dt_)
    y = y + xh * sp["d_skip"][:, None].to(dt_)
    y = norm_apply(sp["norm"], y.reshape(B_, 1, di)) * F.silu(z)
    out = torch.einsum("bte,ed->btd", y, sp["wo"].to(dt_))
    return plan.act_btd(out), {"conv": conv_state,
                               "state": st.to(cache["state"].dtype)}


def mamba2_cache_init(cfg: Mamba2Config, batch: int, dtype=torch.bfloat16,
                      device="cuda", lead=()):
    """`conv` (B, K-1, di+2GN) in `dtype`, `state` (B, H, P, N) f32, each
    with the leading dims `lead`."""
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros(lead + (batch, cfg.n_heads, cfg.head_dim,
                                     cfg.d_state),
                             dtype=torch.float32, device=device),
    }
