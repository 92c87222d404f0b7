"""Shared model building blocks of the port (``src/repro/models/modules.py``):
plain functions on tensors over the reference's parameter tree.

Design rules (the reference's):
  * every `*_init` returns a nested dict of f32 tensors whose key paths
    match runtime.sharding.PARAM_RULES (``units/0/b0/attn/wq``): the
    checkpoint, the sharding rules and the pager key leaves by these
    paths, so the tree is the state and no ``nn.Module`` re-keys it;
  * an init draws from a ``torch.Generator`` on the device it fills;
    ``key=None`` gives the shapes alone, on the meta device;
  * every `*_apply` is pure, takes a ShardingPlan (mesh=None => no-op
    constraints) and computes in bf16 with f32 accumulation where it
    matters (softmax, norms, the attention scores);
  * attention is the reference's chunked flash forward (bq=512,
    bk=1024), so no (S, S) score matrix is ever built.

Here: GQA/MQA attention with sliding windows, qk-norm, partial RoPE
and M-RoPE, cross-attention, MLA (DeepSeek-V2's latent attention, its
decode absorbed into the compressed cache), the dense MLP, the MoE
(token-choice top-k with static capacity; routing and combine exact
and in a fixed order on any device), the embedding and
the loss: flash attention's backward recomputes its score blocks
(``_Flash``) and ``chunked_xent`` its chunks' logits, so training keeps
neither (S, S) scores nor (B, S, V) logits. The MoE runs expert-parallel
over a model axis of several ranks (each rank its experts, the outputs
summed over the model group in rank order: ``moe_apply``); one process
on a logical mesh computes the same shards in turn
(``moe_block_by_shards``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..runtime.sharding import ShardingPlan

COMPUTE_DTYPE = torch.bfloat16
# finite, so a fully masked row softmaxes to uniform weights, not NaN
NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def key_device(key) -> torch.device:
    """The device an init fills: the generator's, or meta for key=None."""
    return torch.device("meta") if key is None else key.device


def _normal(key, shape, scale):
    shape = tuple(int(s) for s in shape)
    if key is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return scale * torch.randn(shape, generator=key, dtype=torch.float32,
                               device=key.device)


def dense_init(key, in_dim, out_shape, scale=None):
    """Fan-in scaled normal; out_shape may be multi-dim (heads, head_dim)."""
    if scale is None:
        scale = in_dim ** -0.5
    return _normal(key, (in_dim,) + tuple(np.atleast_1d(out_shape)), scale)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(dim, layernorm: bool = False, device="cpu"):
    p = {"scale": torch.zeros(dim, dtype=torch.float32, device=device)}
    if layernorm:                                     # gemma-style (1+scale)
        p["bias"] = torch.zeros(dim, dtype=torch.float32, device=device)
    return p


def norm_apply(p, x, eps=1e-6):
    xf = x.float()
    if "bias" in p:                                   # LayerNorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * (1.0 + p["scale"]) + p["bias"]
    else:                                             # RMSNorm
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE, partial RoPE, M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, rotary_dim: Optional[int] = None,
               device="cpu"):
    rd = rotary_dim or head_dim
    inv = 1.0 / (theta ** (np.arange(0, rd, 2, dtype=np.float64) / rd))
    return torch.from_numpy(inv.astype(np.float32)).to(device)   # (rd/2,)


@functools.lru_cache(maxsize=None)
def _rope_table(head_dim: int, theta: float, rotary_dim: int, device):
    """rope_freqs on `device`, made once: a host-to-device copy in every
    layer of every step would make the host wait for the device."""
    return rope_freqs(head_dim, theta, rotary_dim, device)


def _rotate(x, ang, rd):
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr.chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([rotated.to(x.dtype), x[..., rd:]], -1)


def apply_rope(x, positions, inv_freqs, rotary_dim: Optional[int] = None):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    rd = rotary_dim or x.shape[-1]
    ang = positions[..., :, None].float() * inv_freqs        # (..., S, rd/2)
    return _rotate(x, ang, rd)


def apply_mrope(x, positions3, inv_freqs, sections: Tuple[int, int, int]):
    """Qwen2-VL multimodal RoPE: the rd/2 frequency lanes are split into
    (t, h, w) sections, each driven by its own position stream.
    positions3: (3, ..., S). Stream i is ``positions3[i]`` as jnp indexes
    it: a static index past the end clamps to the last row (decode passes
    (B, 1) positions, whose rows are all the same step)."""
    secs = np.cumsum((0,) + tuple(sections))
    ang_parts = []
    for i in range(3):
        f = inv_freqs[secs[i]:secs[i + 1]]
        p = positions3[min(i, positions3.shape[0] - 1)]
        ang_parts.append(p[..., :, None].float() * f)
    ang = torch.cat(ang_parts, -1)                         # (..., S, rd/2)
    return _rotate(x, ang, 2 * int(secs[-1]))


# ---------------------------------------------------------------------------
# flash attention (chunked double loop, forward and backward)
# ---------------------------------------------------------------------------

def _block_scores(qblk, kblk, cfg, qi, kj):
    """(B, H, bq, bk) f32 masked scores for one (q-chunk, kv-chunk) pair."""
    causal, window, q_offset, bq, bk, scale, Sk_real = cfg
    B = qblk.shape[0]
    K, D = kblk.shape[2], kblk.shape[3]
    H = qblk.shape[2]
    G = H // K
    dev = qblk.device
    q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
    k_pos = kj * bk + torch.arange(bk, device=dev)
    qg = qblk.reshape(B, bq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kblk.float()) * scale
    s = s.reshape(B, H, bq, bk)
    mask = (k_pos[None, :] < Sk_real).expand(bq, bk)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return torch.where(mask[None, None], s, NEG_INF)


def _flash_fwd(cfg, q, k, v):
    """-> (out (B,Sq,H,Dv), lse (B,H,Sq))."""
    causal, window, q_offset, bq, bk, scale, Sk_real = cfg
    B, Sq, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    G = H // K
    nq, nk = Sq // bq, k.shape[1] // bk
    f32 = dict(dtype=torch.float32, device=q.device)
    outs, lses = [], []
    for qi in range(nq):
        qblk = q[:, qi * bq:(qi + 1) * bq]
        m = torch.full((B, H, bq), NEG_INF, **f32)
        l = torch.zeros((B, H, bq), **f32)
        acc = torch.zeros((B, H, bq, Dv), **f32)
        for kj in range(nk):
            kblk = k[:, kj * bk:(kj + 1) * bk]
            vblk = v[:, kj * bk:(kj + 1) * bk]
            s = _block_scores(qblk, kblk, cfg, qi, kj)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            # p and v rounded to bf16, the product accumulated in f32
            pg = p.reshape(B, K, G, bq, bk).to(torch.bfloat16).float()
            pvg = torch.einsum("bkgqs,bskd->bkgqd", pg,
                               vblk.to(torch.bfloat16).float())
            acc = acc * corr[..., None] + pvg.reshape(B, H, bq, Dv)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
        outs.append(out.to(q.dtype))
    out = torch.cat(outs, 2)                                # (B,H,Sq,Dv)
    return out.transpose(1, 2), torch.cat(lses, 2)


def _bf(x):
    """x rounded to bf16, held in f32: a product of two such values is
    exact in f32, so an f32 einsum of them is the reference's bf16
    product with ``preferred_element_type=f32``."""
    return x.to(torch.bfloat16).float()


def _flash_bwd(cfg, q, k, v, out, lse, do):
    """The reference's ``_flash_bwd_rule``: every (bq, bk) score block
    recomputed from q, k and lse, an outer loop over kv blocks and an
    inner one over q blocks; p and do, do and v, ds * scale rounded to
    bf16 where the reference rounds them, the products summed in f32.
    -> (dq, dk, dv) in q's, k's and v's dtypes."""
    causal, window, q_offset, bq, bk, scale, Sk_real = cfg
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // K
    nq, nk = Sq // bq, Sk // bk
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(), out.float())
    dq = [torch.zeros((B, bq, H, D), dtype=torch.float32, device=q.device)
          for _ in range(nq)]
    dks, dvs = [], []
    for kj in range(nk):
        kblk = k[:, kj * bk:(kj + 1) * bk]
        kb = _bf(kblk)
        vb = _bf(v[:, kj * bk:(kj + 1) * bk])
        dk_a = torch.zeros((B, bk, K, D), dtype=torch.float32,
                           device=q.device)
        dv_a = torch.zeros((B, bk, K, Dv), dtype=torch.float32,
                           device=q.device)
        for qi in range(nq):
            sl = slice(qi * bq, (qi + 1) * bq)
            qblk = q[:, sl]
            s = _block_scores(qblk, kblk, cfg, qi, kj)        # (B,H,bq,bk)
            p = torch.exp(s - lse[:, :, sl, None]).reshape(B, K, G, bq, bk)
            dog = _bf(do[:, sl].reshape(B, bq, K, G, Dv))
            dv_a = dv_a + torch.einsum("bkgqs,bqkgd->bskd", _bf(p), dog)
            dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vb)
            ds = p * (dp - delta[:, :, sl].reshape(B, K, G, bq)[..., None])
            ds = _bf(ds * scale)
            dq[qi] = dq[qi] + torch.einsum("bkgqs,bskd->bqkgd", ds,
                                           kb).reshape(B, bq, H, D)
            dk_a = dk_a + torch.einsum(
                "bkgqs,bqkgd->bskd", ds, _bf(qblk.reshape(B, bq, K, G, D)))
        dks.append(dk_a)
        dvs.append(dv_a)
    return (torch.cat(dq, 1).to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` flash: the backward recomputes
    the score blocks, so only q, k, v, out and the (B, H, Sq) lse are
    saved and nothing (Sq, Sk)-sized outlives the forward (a backward
    through the forward's loops would keep every block's scores)."""

    @staticmethod
    def forward(ctx, cfg, q, k, v):
        out, lse = _flash_fwd(cfg, q, k, v)
        ctx.cfg = cfg
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        return (None,) + _flash_bwd(ctx.cfg, *ctx.saved_tensors, do)


def flash_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                    q_offset: int = 0, bq: int = 512, bk: int = 1024,
                    scale: Optional[float] = None):
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D) with H % K == 0 (GQA).

    Returns (B, Sq, H, D). Never materializes more than (B, H, bq, bk)
    scores in either direction: the backward (:class:`_Flash`)
    recomputes score blocks instead of saving them. Masking is
    positional: query i attends keys j with j <= i + q_offset (causal),
    j > i + q_offset - window.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    bq = min(bq, Sq)
    bk = min(bk, Sk)
    # pad to chunk multiples (whisper's 1500 frames, VLM text tails);
    # padded keys are masked via Sk_real, padded queries sliced off
    pq = (-Sq) % bq
    pk = (-Sk) % bk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    cfg = (causal, window, q_offset, bq, bk, scale, Sk)
    return _Flash.apply(cfg, q, k, v)[:, :Sq]


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rotary_frac: float = 1.0               # partial rotary (GLM: 0.5)
    window: Optional[int] = None           # sliding window (gemma3 local)
    qk_norm: bool = False                  # gemma3
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    causal: bool = True
    query_scale: Optional[float] = None    # override 1/sqrt(D)


def attn_init(key, cfg: AttnConfig):
    d, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(key, d, (H, D)),
        "wk": dense_init(key, d, (K, D)),
        "wv": dense_init(key, d, (K, D)),
        "wo": _normal(key, (H, D, d), (H * D) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(D, device=key_device(key))
        p["k_norm"] = norm_init(D, device=key_device(key))
    return {"attn": p}


def _rotary_dim(cfg: AttnConfig) -> int:
    rd = int(cfg.head_dim * cfg.rotary_frac)
    return rd - rd % 2


def _qkv(p, cfg, x, positions, plan: ShardingPlan):
    ap = p["attn"]
    dt = x.dtype
    q = torch.einsum("btd,dhk->bthk", x, ap["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", x, ap["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", x, ap["wv"].to(dt))
    q = plan.act_bthd(q)
    if cfg.qk_norm:
        q = norm_apply(ap["q_norm"], q)
        k = norm_apply(ap["k_norm"], k)
    inv = _rope_table(cfg.head_dim, cfg.rope_theta, _rotary_dim(cfg),
                      x.device)
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, inv, cfg.mrope_sections)
        k = apply_mrope(k, positions, inv, cfg.mrope_sections)
    elif cfg.rotary_frac > 0:
        q = apply_rope(q, positions, inv, _rotary_dim(cfg))
        k = apply_rope(k, positions, inv, _rotary_dim(cfg))
    return q, k, v


def attn_apply(p, cfg: AttnConfig, x, positions, plan: ShardingPlan,
               q_offset: int = 0):
    """Training / prefill path. x: (B, S, d). Returns (out, (k, v))."""
    q, k, v = _qkv(p, cfg, x, positions, plan)
    out = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                          q_offset=q_offset, scale=cfg.query_scale)
    out = plan.act_bthd(out)
    y = torch.einsum("bthk,hkd->btd", out, p["attn"]["wo"].to(x.dtype))
    return plan.act_btd(y), (k, v)


def cross_attn_apply(p, cfg: AttnConfig, x, memory, plan: ShardingPlan):
    """Encoder-decoder cross attention (whisper). No RoPE, non-causal."""
    ap = p["attn"]
    dt = x.dtype
    q = torch.einsum("btd,dhk->bthk", x, ap["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", memory, ap["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", memory, ap["wv"].to(dt))
    out = flash_attention(q, k, v, causal=False, scale=cfg.query_scale)
    y = torch.einsum("bthk,hkd->btd", out, ap["wo"].to(dt))
    return plan.act_btd(y)


def masked_cache_write(cache_seq, new, slot):
    """Write (B,1,...) `new` at position `slot` (B,) along axis 1 by an
    index-compare select (the reference's layout rule: elementwise, so a
    sequence-sharded cache updates locally). Returns a new tensor."""
    L = cache_seq.shape[1]
    idx = torch.arange(L, device=cache_seq.device)
    hit = idx[None, :] == slot[:, None]                     # (B, L)
    hit = hit.reshape(hit.shape + (1,) * (cache_seq.ndim - 2))
    return torch.where(hit, new.to(cache_seq.dtype), cache_seq)


def attn_decode(p, cfg: AttnConfig, x, pos, cache, plan: ShardingPlan):
    """Single-token decode. x: (B, 1, d); cache: dict(k,v): (B, S, K, D)."""
    q, k_new, v_new = _qkv(p, cfg, x, pos[..., None] if pos.ndim == 1
                           else pos, plan)
    # write the new token into the cache at `pos`
    k_cache = masked_cache_write(cache["k"], k_new, pos)
    v_cache = masked_cache_write(cache["v"], v_new, pos)
    cb, cseq = plan.cache_kv_spec()
    k_cache = plan.cs(k_cache, cb, cseq, None, None)
    v_cache = plan.cs(v_cache, cb, cseq, None, None)

    B, S, K, D = k_cache.shape
    H = cfg.n_heads
    G = H // K
    scale = cfg.query_scale if cfg.query_scale is not None else D ** -0.5
    qg = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     k_cache.to(q.dtype).float()) * scale
    k_pos = torch.arange(S, device=x.device)
    mask = k_pos[None, :] <= pos[:, None]
    if cfg.window is not None:
        mask = mask & (k_pos[None, :] > (pos[:, None] - cfg.window))
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(q.dtype),
                       v_cache.to(q.dtype))
    out = out.reshape(B, 1, H, D)
    y = torch.einsum("bthk,hkd->btd", out, p["attn"]["wo"].to(x.dtype))
    return plan.act_btd(y), {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    rope_theta: float = 10000.0


def mla_init(key, cfg: MLAConfig):
    H, dev = cfg.n_heads, key_device(key)
    p = {
        "wq_a": dense_init(key, cfg.d_model, (cfg.q_lora,)),
        "wq_b": dense_init(key, cfg.q_lora, (H, cfg.qk_nope + cfg.qk_rope)),
        "wkv_a": dense_init(key, cfg.d_model, (cfg.kv_lora + cfg.qk_rope,)),
        "wkv_b": dense_init(key, cfg.kv_lora,
                            (H, cfg.qk_nope + cfg.v_head)),
        "wo": _normal(key, (H, cfg.v_head, cfg.d_model),
                      (H * cfg.v_head) ** -0.5),
        "q_a_norm": norm_init(cfg.q_lora, device=dev),
        "kv_a_norm": norm_init(cfg.kv_lora, device=dev),
    }
    return {"mla": p}


def _mla_scale(cfg: MLAConfig) -> float:
    return (cfg.qk_nope + cfg.qk_rope) ** -0.5


def _mla_q(mp, cfg: MLAConfig, x):
    """(q_nope, q_rope) of x (B, S, d), each (B, S, H, *), before rope."""
    dt = x.dtype
    cq = norm_apply(mp["q_a_norm"], torch.einsum("btd,dq->btq", x,
                                                 mp["wq_a"].to(dt)))
    q = torch.einsum("btq,qhk->bthk", cq, mp["wq_b"].to(dt))
    return q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]


def _mla_kv_a(mp, cfg: MLAConfig, x):
    """(c_kv normed (B, S, kv_lora), k_rope before rope (B, S, qk_rope))."""
    kv_a = torch.einsum("btd,dc->btc", x, mp["wkv_a"].to(x.dtype))
    return (norm_apply(mp["kv_a_norm"], kv_a[..., :cfg.kv_lora]),
            kv_a[..., cfg.kv_lora:])


def mla_apply(p, cfg: MLAConfig, x, positions, plan: ShardingPlan,
              q_offset: int = 0):
    """Prefill MLA. Returns (out, (c_kv, k_rope)), the compressed cache
    of the S positions: (B, S, kv_lora) and (B, S, qk_rope) after rope."""
    mp = p["mla"]
    dt = x.dtype
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(mp, cfg, x)
    c_kv, k_rope = _mla_kv_a(mp, cfg, x)
    kv = torch.einsum("btc,chk->bthk", c_kv, mp["wkv_b"].to(dt))
    k_nope, v = kv[..., :cfg.qk_nope], kv[..., cfg.qk_nope:]
    inv = _rope_table(cfg.qk_rope, cfg.rope_theta, cfg.qk_rope, x.device)
    q_rope = apply_rope(q_rope, positions, inv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, inv)  # (B,S,1,r)
    k_rope_b = k_rope.expand(B, S, H, cfg.qk_rope)
    qf = plan.act_bthd(torch.cat([q_nope, q_rope], -1))
    kf = plan.act_bthd(torch.cat([k_nope, k_rope_b], -1))
    out = flash_attention(qf, kf, v, causal=True, q_offset=q_offset,
                          scale=_mla_scale(cfg))
    out = plan.act_bthd(out)
    y = torch.einsum("bthk,hkd->btd", out, mp["wo"].to(dt))
    return plan.act_btd(y), (c_kv, k_rope[:, :, 0, :])


def mla_decode(p, cfg: MLAConfig, x, pos, cache, plan: ShardingPlan):
    """Decode with the COMPRESSED cache (c_kv (B, S, kv_lora) and k_rope
    (B, S, qk_rope)), attention absorbed into the latent: score = (q_nope
    W_kv_b,k) . c + q_rope . k_rope. The reference's f32-accumulated
    products take bf16 inputs, whose products are exact in f32: they run
    here on f32 copies."""
    mp = p["mla"]
    dt = x.dtype
    q_nope, q_rope = _mla_q(mp, cfg, x)                     # (B,1,H,*)
    c_new, kr_new = _mla_kv_a(mp, cfg, x)                   # (B,1,*)
    inv = _rope_table(cfg.qk_rope, cfg.rope_theta, cfg.qk_rope, x.device)
    q_rope = apply_rope(q_rope, pos[:, None], inv)[:, 0]    # (B,H,r)
    kr_new = apply_rope(kr_new[:, :, None, :], pos[:, None], inv)[:, :, 0]
    ck = masked_cache_write(cache["c_kv"], c_new, pos)
    kr = masked_cache_write(cache["k_rope"], kr_new, pos)
    cb, cseq = plan.cache_kv_spec()
    ck = plan.cs(ck, cb, cseq, None)
    kr = plan.cs(kr, cb, cseq, None)
    w_kv = mp["wkv_b"].to(dt)                               # (c, H, nope+v)
    w_k = w_kv[..., :cfg.qk_nope]                           # (c, H, nope)
    w_v = w_kv[..., cfg.qk_nope:]                           # (c, H, v)
    q_abs = torch.einsum("bhk,chk->bhc", q_nope[:, 0], w_k)  # (B, H, c)
    s = (torch.einsum("bhc,bsc->bhs", q_abs.float(), ck.to(dt).float())
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), kr.to(dt).float()))
    s = s * _mla_scale(cfg)
    S = ck.shape[1]
    mask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    s = torch.where(mask[:, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsc->bhc", w.to(dt), ck.to(dt))
    out = torch.einsum("bhc,chv->bhv", ctx, w_v)             # (B, H, v)
    y = torch.einsum("bhv,hvd->bd", out, mp["wo"].to(dt))[:, None]
    return plan.act_btd(y), {"c_kv": ck, "k_rope": kr}


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / ReLU^2)
# ---------------------------------------------------------------------------

def mlp_init(key, d_model, d_ff, gated: bool = True):
    p = {"wi": dense_init(key, d_model, (d_ff,)),
         "wo": _normal(key, (d_ff, d_model), d_ff ** -0.5)}
    if gated:
        p["wg"] = dense_init(key, d_model, (d_ff,))
    return {"mlp": p}


def _act(name, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def mlp_apply(p, x, plan: ShardingPlan, act: str = "silu"):
    mp = p["mlp"]
    dt = x.dtype
    h = torch.einsum("btd,df->btf", x, mp["wi"].to(dt))
    if "wg" in mp:
        g = torch.einsum("btd,df->btf", x, mp["wg"].to(dt))
        h = _act(act, g) * h
    else:
        h = _act(act, h)
    h = plan.act_btf(h)
    y = torch.einsum("btf,fd->btd", h, mp["wo"].to(dt))
    return plan.act_btd(y)


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, static capacity)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                    # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0            # shared-expert count (DeepSeek)
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    act: str = "silu"


def moe_init(key, cfg: MoEConfig):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(key, d, (E,), scale=d ** -0.5),
        "wi": _normal(key, (E, d, f), d ** -0.5),
        "wg": _normal(key, (E, d, f), d ** -0.5),
        "wo": _normal(key, (E, f, d), f ** -0.5),
    }
    out = {"moe": p}
    if cfg.n_shared:
        out["shared"] = mlp_init(key, d, cfg.shared_d_ff or f * cfg.n_shared)
    return out


def _moe_capacity(tokens: int, cfg: MoEConfig, n_local_experts: int) -> int:
    cap = int(np.ceil(tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, -(-cap // 8) * 8)


def moe_route(gates, top_k: int, first_expert: int, n_local: int,
              capacity: int):
    """Token-choice routing of f32 `gates` (T, E), exact on any device:
    the top k by a stable descending sort (ties to the lower expert, as
    ``jax.lax.top_k``), weights normalised by a sum in slot order, pairs
    sorted stably by expert, each pair's slot in its expert's buffer and
    whether it is kept (its expert in this shard and its slot under
    `capacity`: an overfull expert drops its later tokens). -> dict of
    top_i, top_w (T, K); order, se, st, sw, pos, valid (T K,); counts
    (E,)."""
    T, E = gates.shape
    top_w, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :top_k], top_i[:, :top_k]
    total = top_w[:, 0]
    for j in range(1, top_k):
        total = total + top_w[:, j]
    top_w = top_w / torch.clamp(total, min=1e-9)[:, None]
    flat_e = top_i.reshape(-1)
    flat_t = torch.arange(T, device=gates.device).repeat_interleave(top_k)
    order = torch.sort(flat_e, stable=True)[1]
    se, st, sw = flat_e[order], flat_t[order], top_w.reshape(-1)[order]
    counts = torch.bincount(se, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * top_k, device=gates.device) - starts[se]
    e_loc = se - first_expert
    valid = (e_loc >= 0) & (e_loc < n_local) & (pos < capacity)
    return dict(top_i=top_i, top_w=top_w, order=order, se=se, st=st, sw=sw,
                counts=counts, pos=pos, valid=valid)


def _combine(y_pairs, order, T: int, top_k: int):
    """y (T, d) f32: each token's pair contributions (T K, d, in sorted
    pair order) added from zero in that order, as the reference's
    scatter-add ``.at[st].add`` does on the CPU: a token's pairs sort by
    expert, and the sort is stable. No atomics, so the sum is the same on
    every run and device."""
    d = y_pairs.shape[-1]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    # each token's K pairs in sorted order: its pair indices by rank
    by_rank = torch.sort(rank.view(T, top_k), -1)[0]         # (T, K)
    y = torch.zeros((T, d), dtype=torch.float32, device=y_pairs.device)
    for j in range(top_k):
        y = y + y_pairs[by_rank[:, j]]
    return y


def moe_local_math(x2d, mp, cfg: MoEConfig, first_expert, n_local, capacity,
                   with_route: bool = False):
    """Token-choice top-k with static capacity on ONE expert shard.

    x2d: (T, d) tokens. Computes only experts [first_expert, first_expert
    + n_local); the caller sums across shards. Scatter/gather based: no
    (T, E, C) one-hot dispatch tensor is built. -> (y (T, d) in x2d's
    dtype, the load-balance aux), and :func:`moe_route`'s dict with
    `with_route`."""
    T, d = x2d.shape
    dt = x2d.dtype
    logits = torch.einsum("td,de->te", x2d, mp["router"].to(dt))
    gates = torch.softmax(logits.float(), -1)
    r = moe_route(gates, cfg.top_k, first_expert, n_local, capacity)
    valid, st = r["valid"], r["st"]
    safe_e = torch.where(valid, r["se"] - first_expert, 0)
    safe_p = torch.where(valid, r["pos"], capacity)          # dump slot
    buf = torch.zeros((n_local, capacity + 1, d), dtype=dt,
                      device=x2d.device)
    buf[safe_e, safe_p] = torch.where(valid[:, None], x2d[st], 0).to(dt)
    buf = buf[:, :capacity]
    # expert FFN (gated)
    h = torch.einsum("ecd,edf->ecf", buf, mp["wi"].to(dt))
    g = torch.einsum("ecd,edf->ecf", buf, mp["wg"].to(dt))
    h = _act(cfg.act, g) * h
    y_buf = torch.einsum("ecf,efd->ecd", h, mp["wo"].to(dt))
    y_buf = torch.cat([y_buf, torch.zeros((n_local, 1, d), dtype=dt,
                                          device=x2d.device)], 1)
    # bf16 times f32 promotes to f32, as in jnp
    y_pairs = y_buf[safe_e, safe_p].float() * \
        torch.where(valid, r["sw"], 0.0)[:, None]
    y = _combine(y_pairs, r["order"], T, cfg.top_k)
    # router aux (load balance) on this shard's view
    me = gates.mean(0)
    counts = r["counts"]
    ce = counts.float() / torch.clamp(counts.sum(), min=1).float()
    aux = cfg.n_experts * torch.sum(me * ce)
    if with_route:
        return y.to(dt), aux, r
    return y.to(dt), aux


def _expert_slice(mp, first: int, n_local: int):
    """The router and experts [first, first + n_local) of an MoE leaf
    dict."""
    sl = slice(first, first + n_local)
    return {"router": mp["router"], "wi": mp["wi"][sl],
            "wg": mp["wg"][sl], "wo": mp["wo"][sl]}


def _experts_per_shard(cfg: MoEConfig, ms: int) -> int:
    if cfg.n_experts % ms:
        raise ValueError(f"experts must divide model axis: {cfg.n_experts} "
                         f"experts over a model axis of {ms}")
    return cfg.n_experts // ms


def moe_block_by_shards(x2d, mp, cfg: MoEConfig, n_shards: int,
                        capacity: int, with_routes: bool = False):
    """Expert parallelism over `n_shards` model shards in ONE process:
    shard m's :func:`moe_local_math` over experts [m E/n, (m+1) E/n) at
    `capacity`, the shards' outputs summed in f32 from 0 in shard order
    and cast back, as a rank's model group sums them (``moe_apply``) and
    the reference's ``psum`` does. -> (y (T, d) in x2d's dtype, shard 0's
    aux; with `with_routes`, each shard's :func:`moe_route` dict)."""
    nl = _experts_per_shard(cfg, n_shards)
    acc = torch.zeros(x2d.shape, dtype=torch.float32, device=x2d.device)
    routes, aux0 = [], None
    for m in range(n_shards):
        y, aux, r = moe_local_math(x2d, _expert_slice(mp, m * nl, nl), cfg,
                                   m * nl, nl, capacity, with_route=True)
        acc = acc + y.float()
        routes.append(r)
        aux0 = aux if aux0 is None else aux0
    y = acc.to(x2d.dtype)
    return (y, aux0, routes) if with_routes else (y, aux0)


def _moe_ep_ranks(x2d, mp, cfg: MoEConfig, plan: ShardingPlan, cap: int):
    """Expert parallelism on a rank mesh: this rank's experts over its
    batch rows, the f32 outputs summed over the model group in rank
    order. The tokens and the MoE leaves every model rank holds alike
    enter through ``group_copy`` (their cotangents summed over the group
    in the backward), the output leaves through ``group_sum`` (its
    cotangent passed to every member); the aux, alike on every model
    rank, carries its gradient on model rank 0 only, so the sum counts
    it once — the reference's gradients (one-device ones, unscaled)."""
    from ..runtime.dist import group_copy, group_mean, group_sum
    mg = plan.mesh.group(plan.model_axis)
    nl = _experts_per_shard(cfg, mg.size)
    first = mg.index * nl
    mp_loc = _expert_slice({k: group_copy(v, mg) for k, v in mp.items()
                            if k in ("router", "wi", "wg", "wo")}, first, nl)
    y_loc, aux = moe_local_math(group_copy(x2d, mg), mp_loc, cfg, first, nl,
                                cap)
    y = group_sum(y_loc.float(), mg).to(x2d.dtype)
    if mg.index != 0:
        aux = aux.detach()
    return y, group_mean(aux, plan.batch_group())


def moe_apply(p, cfg: MoEConfig, x, plan: ShardingPlan):
    """x: (B, S, d) -> (y, aux_loss).

    Without a model axis (or of size 1) all experts run at once over the
    whole batch (on a rank mesh with a batch axis the rows are gathered
    over the batch group first, as the reference routes its global
    batch). Over a model axis of several positions each shard takes
    E / model experts at the capacity of the rows of one batch position
    (the reference's shard_map): on a rank mesh every rank its own shard
    (:func:`_moe_ep_ranks`); on a logical mesh one process each batch
    block's shards in turn (:func:`moe_block_by_shards`), the aux
    averaged over the batch blocks."""
    from ..runtime.sharding import is_rank_plan
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    mp = p["moe"]
    ranks = is_rank_plan(plan)
    if plan.mesh is None or plan.model_size == 1:
        # a decode_wide rank holds the whole batch already
        if ranks and plan.batch_group().size > 1 and not plan.decode_wide:
            from ..runtime.dist import gather_rows
            g = plan.batch_group()
            xa = gather_rows(x2d, g)
            cap = _moe_capacity(xa.shape[0], cfg, cfg.n_experts)
            ya, aux = moe_local_math(xa, mp, cfg, 0, cfg.n_experts, cap)
            y = ya[g.index * B * S:(g.index + 1) * B * S]
        else:
            cap = _moe_capacity(B * S, cfg, cfg.n_experts)
            y, aux = moe_local_math(x2d, mp, cfg, 0, cfg.n_experts, cap)
    elif ranks:
        # the rank holds its batch position's rows: B is already B / dp
        # (in serving with decode_wide, the whole batch on every rank)
        ms = plan.model_size
        cap = _moe_capacity(B * S, cfg, _experts_per_shard(cfg, ms))
        y, aux = _moe_ep_ranks(x2d, mp, cfg, plan, cap)
    else:
        ms = plan.model_size
        dp = int(np.prod([plan.axis_size(a) for a in plan.batch_axes]))
        cap = _moe_capacity(B * S // dp, cfg, _experts_per_shard(cfg, ms))
        ys, auxes = [], []
        for blk in x2d.chunk(dp):
            yb, ab = moe_block_by_shards(blk, mp, cfg, ms, cap)
            ys.append(yb)
            auxes.append(ab)
        y = torch.cat(ys)
        aux = auxes[0]
        for a in auxes[1:]:
            aux = aux + a
        aux = aux / dp
    y = y.reshape(B, S, d)
    if "shared" in p:
        y = y + mlp_apply({"mlp": p["shared"]["mlp"]}, x, plan, act=cfg.act)
    return plan.act_btd(y), aux


# ---------------------------------------------------------------------------
# embedding + chunked softmax cross-entropy
# ---------------------------------------------------------------------------

def embed_init(key, vocab: int, d_model: int):
    # d^-0.5 keeps tied-head logits O(1) at init (loss starts near ln V)
    return {"embed": {"table": _normal(key, (vocab, d_model),
                                       d_model ** -0.5)}}


def _rounded(scale: float, dtype) -> float:
    """`scale` rounded to `dtype`, as a python float (a host scalar: no
    device tensor to make on every call)."""
    return float(torch.tensor(scale, dtype=dtype))


def embed_apply(p, tokens, plan: ShardingPlan, scale: Optional[float] = None):
    # gather, then cast: the reference's cast-then-take, one row at a time
    x = p["embed"]["table"][tokens.long()].to(COMPUTE_DTYPE)
    if scale is not None:
        # the reference's x * scale in the compute dtype: scale rounded
        # to it first, the product rounded once
        x = x * _rounded(scale, COMPUTE_DTYPE)
    return plan.act_btd(x)


def unembed_logits(p, h, plan: ShardingPlan, softcap: Optional[float] = None):
    table = p["embed"]["table"].to(h.dtype)
    # one (B T, d) x (d, V) product against the table's transposed view:
    # a bmm (einsum's, or matmul's on a strided h) copies the table on
    # every call for bf16 on the CPU
    B, S, d = h.shape
    logits = (h.reshape(B * S, d) @ table.T).reshape(B, S, -1)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return plan.logits_btv(logits)


def _xent_chunk(p, h, labels, plan, softcap):
    """sum(logsumexp - gold) of one chunk's f32 logits."""
    logits = unembed_logits(p, h, plan, softcap).float()
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(logz - gold)


def chunked_xent(p, h, labels, plan: ShardingPlan,
                 softcap: Optional[float] = None, chunk: int = 512):
    """Mean cross-entropy of h (B, S, d) against labels (B, S) without
    (B, S, V) logits at once: the chunks of the largest divisor of S at
    most `chunk`, their sums added in order from 0, over B S. Under
    autograd each chunk runs under ``checkpoint``: its logits are
    recomputed in the backward, so one chunk's are live at a time."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    while S % chunk:                 # largest divisor of S at most `chunk`
        chunk -= 1
    grad = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        args = (p, h[:, i:i + chunk], labels[:, i:i + chunk], plan, softcap)
        total = total + (checkpoint(_xent_chunk, *args, use_reentrant=False)
                         if grad else _xent_chunk(*args))
    return total / (B * S)
