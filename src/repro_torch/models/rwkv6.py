"""RWKV-6 "Finch" of the port (``src/repro/models/rwkv6.py``): the
attention-free time mix with data-dependent decay, and the channel mix.

Chunked-parallel form for prefill (GLA-style, chunk=16 with mid-chunk
renormalization to keep exp(cum-log-decay) ratios inside f32 range;
per-step log-decay clamped to [-5, 0] — the reference's documented
deviation, reproduced as written), plus the exact recurrent form for
decode. The state is (B,H,P,P) f32; the recurrence across chunks is a
sequential loop.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..runtime.sharding import ShardingPlan
from .modules import _normal, dense_init, key_device, norm_apply, norm_init

LOG_W_MIN = -5.0
CHUNK = 16


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    head_dim: int = 64
    lora_rank: int = 32
    d_ff: int = 0                 # channel-mix hidden (7168 for 1.6b)

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def rwkv6_init(key, cfg: RWKV6Config):
    dev = key_device(key)
    d, H, P = cfg.d_model, cfg.n_heads, cfg.head_dim
    r = cfg.lora_rank
    p = {
        # token-shift mix coefficients for (x_for_lora, r, k, v, w, g)
        "maa": _normal(key, (6, d), 0.02),
        "lora_w1": _normal(key, (d, 5 * r), d ** -0.5),      # ddlerp lora
        "lora_w2": _normal(key, (5, r, d), r ** -0.5),
        "decay_base": torch.full((d,), -1.0, dtype=torch.float32,
                                 device=dev),
        "decay_w1": _normal(key, (d, 2 * r), d ** -0.5),
        "decay_w2": _normal(key, (2 * r, d), r ** -0.5),
        "bonus_u": _normal(key, (H, P), 0.5),
        "wr": dense_init(key, d, (d,)),
        "wk": dense_init(key, d, (d,)),
        "wv": dense_init(key, d, (d,)),
        "wg": dense_init(key, d, (d,)),
        "wo": _normal(key, (d, d), d ** -0.5),
        "gn": norm_init(d, device=dev),                      # group-ish norm
    }
    return {"ssm": p}


def rwkv6_cmix_init(key, cfg: RWKV6Config):
    d = cfg.d_model
    return {"ssm_cmix": {
        "maa_k": _normal(key, (d,), 0.02),
        "maa_r": _normal(key, (d,), 0.02),
        "wk": dense_init(key, d, (cfg.d_ff,)),
        "wv": _normal(key, (cfg.d_ff, d), cfg.d_ff ** -0.5),
        "wr": dense_init(key, d, (d,)),
    }}


def _shifted(x, last=None):
    """x_{t-1} along seq; `last` (B,d) supplies t=-1 context at decode."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], 1)


def _mixes(sp, x, last=None):
    """Data-dependent token-shift (ddlerp) producing (xr, xk, xv, xw, xg)."""
    dt = x.dtype
    sx = _shifted(x, last) - x
    xx = x + sx * sp["maa"][0].to(dt)
    lo = torch.tanh(torch.einsum("btd,dr->btr", xx, sp["lora_w1"].to(dt)))
    B, S = x.shape[:2]
    lo = lo.reshape(B, S, 5, -1)
    dyn = torch.einsum("btfr,frd->btfd", lo, sp["lora_w2"].to(dt))
    outs = []
    for i in range(5):
        mi = sp["maa"][i + 1].to(dt) + dyn[:, :, i]
        outs.append(x + sx * mi)
    return outs  # xr, xk, xv, xw, xg


def _rkvwg(sp, x, cfg: RWKV6Config, last=None):
    dt = x.dtype
    B, S = x.shape[:2]
    H, P = cfg.n_heads, cfg.head_dim
    xr, xk, xv, xw, xg = _mixes(sp, x, last)
    proj = lambda xi, name: torch.einsum("btd,de->bte", xi, sp[name].to(dt))
    r = proj(xr, "wr").reshape(B, S, H, P)
    k = proj(xk, "wk").reshape(B, S, H, P)
    v = proj(xv, "wv").reshape(B, S, H, P)
    g = F.silu(proj(xg, "wg"))
    dd = torch.tanh(torch.einsum("btd,dr->btr", xw, sp["decay_w1"].to(dt)))
    dd = torch.einsum("btr,rd->btd", dd, sp["decay_w2"].to(dt))
    logw = -torch.exp(torch.clamp(sp["decay_base"].float() + dd.float(),
                                  -8.0, 1.0))
    logw = torch.clamp(logw, LOG_W_MIN, -1e-4).reshape(B, S, H, P)
    return r, k, v, g, logw


def _wkv_chunked(r, k, v, logw, u, init_state=None):
    """Chunked WKV. r,k,v,logw: (B,S,H,P); u: (H,P). S must be a multiple
    of CHUNK: the reference reshapes without padding, and raises on any
    other length.

    y_t = sum_{s<t} (prod_{j=s+1..t-1} w_j) . (r_t k_s) v_s + (u.r_t k_t) v_t
    state S_t[p, q] over (key-dim p, value-dim q).
    """
    B, S, H, P = r.shape
    if S % CHUNK:
        raise ValueError(f"_wkv_chunked needs a sequence length that is a "
                         f"multiple of {CHUNK}, as the reference; got {S}")
    nc = S // CHUNK
    rc = lambda t: t.float().reshape(B, nc, CHUNK, H, P)
    r_, k_, v_, lw_ = rc(r), rc(k), rc(v), rc(logw)
    a = torch.cumsum(lw_, 2)                          # within-chunk cum log w
    a_tot = a[:, :, -1]                               # (B,nc,H,P)
    mid = a_tot * 0.5
    # intra-chunk pairwise: decay(t,s) = exp(a_{t-1} - a_s), s < t
    r_dec = r_ * torch.exp(a - lw_ - mid[:, :, None])  # r_t exp(a_{t-1}-mid)
    k_dec = k_ * torch.exp(mid[:, :, None] - a)        # k_s exp(mid - a_s)
    scores = torch.einsum("bclhp,bcmhp->bchlm", r_dec, k_dec)
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=r.device), -1)
    scores = torch.where(tri, scores, 0.0)
    bonus = torch.einsum("bclhp,bclhp->bclh", r_, k_ * u)
    y_intra = (torch.einsum("bchlm,bcmhp->bclhp", scores, v_)
               + bonus[..., None] * v_)
    # chunk state contributions: sum_s exp(a_tot - a_s) k_s v_s^T
    k_st = k_ * torch.exp(a_tot[:, :, None] - a)
    states = torch.einsum("bclhp,bclhq->bchpq", k_st, v_)
    carry = (torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):            # sequential, each step emitting the
        prev.append(carry)         # state before it
        carry = carry * torch.exp(a_tot[:, c])[..., None] + states[:, c]
    prev = torch.stack(prev, 1)                       # (B,nc,H,P,P)
    r_in = r_ * torch.exp(a - lw_)                    # r_t exp(a_{t-1})
    y_inter = torch.einsum("bclhp,bchpq->bclhq", r_in, prev)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y, carry


def rwkv6_apply(p, cfg: RWKV6Config, x, plan: ShardingPlan):
    sp = p["ssm"]
    B, S, d = x.shape
    r, k, v, g, logw = _rkvwg(sp, x, cfg)
    y, state = _wkv_chunked(r, k, v, logw, sp["bonus_u"].float())
    y = norm_apply(sp["gn"], y.reshape(B, S, d).to(x.dtype)) * g
    out = torch.einsum("btd,de->bte", y, sp["wo"].to(x.dtype))
    return plan.act_btd(out), state


def rwkv6_decode(p, cfg: RWKV6Config, x, cache, plan: ShardingPlan):
    """cache: {'sx': (B,d), 'state': (B,H,P,P)}; x: (B,1,d). Returns new
    tensors: `sx` x's token in the compute dtype, `state` f32."""
    sp = p["ssm"]
    B, _, d = x.shape
    r, k, v, g, logw = _rkvwg(sp, x, cfg, last=cache["sx"])
    r1, k1, v1 = (t[:, 0].float() for t in (r, k, v))
    w1 = torch.exp(logw[:, 0])
    st = cache["state"].float()
    u = sp["bonus_u"].float()
    kv = k1[..., None] * v1[..., None, :]             # "bhp,bhq->bhpq"
    y = torch.einsum("bhp,bhpq->bhq", r1, st + u[None, :, :, None] * kv)
    st = st * w1[..., None] + kv
    y = norm_apply(sp["gn"], y.reshape(B, 1, d).to(x.dtype)) * g
    out = torch.einsum("btd,de->bte", y, sp["wo"].to(x.dtype))
    return plan.act_btd(out), {"sx": x[:, 0], "state": st}


def rwkv6_cmix_apply(p, cfg: RWKV6Config, x, plan: ShardingPlan,
                     last=None):
    """Channel mix (the RWKV FFN). Returns (y, new_last)."""
    cp = p["ssm_cmix"]
    dt = x.dtype
    sx = _shifted(x, last) - x
    xk = x + sx * cp["maa_k"].to(dt)
    xr = x + sx * cp["maa_r"].to(dt)
    h = torch.einsum("btd,df->btf", xk, cp["wk"].to(dt))
    h = torch.square(F.relu(h))
    h = plan.act_btf(h)
    kv = torch.einsum("btf,fd->btd", h, cp["wv"].to(dt))
    rr = torch.sigmoid(torch.einsum("btd,de->bte", xr, cp["wr"].to(dt)))
    return plan.act_btd(rr * kv), x[:, -1]


def rwkv6_cache_init(cfg: RWKV6Config, batch: int, dtype=torch.bfloat16,
                     device="cuda", lead=()):
    """`sx`, `sx_cmix` (B, d) in `dtype`, `state` (B, H, P, P) f32, each
    with the leading dims `lead`."""
    lead = tuple(lead)
    z = lambda *s, dt=dtype: torch.zeros(lead + s, dtype=dt, device=device)
    return {
        "sx": z(batch, cfg.d_model),
        "sx_cmix": z(batch, cfg.d_model),
        "state": z(batch, cfg.n_heads, cfg.head_dim, cfg.head_dim,
                   dt=torch.float32),
    }
