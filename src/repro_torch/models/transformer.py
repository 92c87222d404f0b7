"""Unified LM of the port (``src/repro/models/transformer.py``):
heterogeneous block schedules over stacked per-unit parameters.

A model is a sequence of UNITS; each unit is a pattern of blocks repeated
R times, each parameter leaf stacked on a leading repeat axis (the
reference's scan-over-layers layout, so checkpoint paths and sharding
rules are the same). The layer loop is a Python loop over that axis
taking views of the stacked leaves, no copies. With ``remat='block'``
and grad enabled each repeat runs under ``torch.utils.checkpoint``
(the reference's ``jax.checkpoint`` of the scan body with
``nothing_saveable``): the backward keeps one repeat's input and
recomputes the rest. Heterogeneous schedules (gemma3's 5 local : 1
global) put the whole repeating pattern inside one unit.

Block kinds: 'attn' (GQA/MQA, optional sliding window / qk-norm /
M-RoPE / cross-attention), 'mla' (DeepSeek latent attention, decoding
from its compressed cache), 'mamba' (SSD), 'rwkv' (RWKV-6). MLP kinds:
'dense', 'moe' (token-choice top-k on one device), 'rwkv_cmix',
'none'. A block with ``use_shared`` (zamba2's shared block) reads
``params['shared']`` and keeps a cache of its own at every insertion.

Decode caches: windowed attention layers use RING buffers (window
slots, not context slots), taken only when the cache was sized to the
window; the SSM blocks keep a fixed-size state (mamba's conv window and
SSD state, rwkv's token shifts and WKV state), new tensors every step.

Over a rank mesh the serving functions take `shards` (``launch/serve.py::
ServeShards``): the parameters are the rank's shards and the cache the
rank's slices, and each unit's parameters and cache leaves are gathered
whole as the unit runs (the top-level leaves once a call), the
one-device arithmetic runs on the rank's rows, and the rank keeps its
slice of each updated cache leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..runtime.fused import target_device
from ..runtime.sharding import ShardingPlan
from . import mamba2 as M2
from . import modules as mod
from . import rwkv6 as R6
from .modules import AttnConfig, MLAConfig, MoEConfig


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str                                # attn | mla | mamba | rwkv
    attn: Optional[AttnConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[M2.Mamba2Config] = None
    rwkv: Optional[R6.RWKV6Config] = None
    mlp_kind: str = "dense"                  # dense | moe | rwkv_cmix | none
    d_ff: int = 0
    moe: Optional[MoEConfig] = None
    act: str = "silu"
    gated: bool = True
    post_norms: bool = False                 # gemma3 sandwich
    layernorm: bool = False                  # whisper uses LayerNorm
    cross_attn: bool = False                 # whisper decoder
    use_shared: bool = False                 # zamba2 shared block


@dataclasses.dataclass(frozen=True)
class UnitSpec:
    repeat: int
    blocks: Tuple[BlockSpec, ...]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    attn: AttnConfig
    d_ff: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab_size: int
    units: Tuple[UnitSpec, ...]
    embed_scale: bool = False                # gemma: sqrt(d_model)
    final_softcap: Optional[float] = None
    shared_block: Optional[BlockSpec] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None           # None | audio | vision
    frontend_len: int = 0
    layernorm: bool = False
    mrope_sections: Optional[Tuple[int, int, int]] = None
    remat: str = "block"                     # none | block
    sub_quadratic: bool = False              # eligible for long_500k

    @property
    def n_layers(self) -> int:
        return sum(u.repeat * len(u.blocks) for u in self.units)


# ---------------------------------------------------------------------------
# stacked trees
# ---------------------------------------------------------------------------

def _stack(trees):
    """R trees of one structure -> one tree, each leaf stacked on a new
    leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _index(tree, r: int):
    """Repeat r of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _encoder_block(enc: EncoderConfig) -> BlockSpec:
    return BlockSpec(kind="attn",
                     attn=dataclasses.replace(enc.attn, causal=False,
                                              rotary_frac=0.0),
                     mlp_kind="dense", d_ff=enc.d_ff, gated=False,
                     act="gelu", layernorm=True)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(key, b: BlockSpec, d_model: int):
    if b.use_shared:
        return {}          # params live once in params['shared']
    dev = mod.key_device(key)
    p: Dict[str, Any] = {"ln1": mod.norm_init(d_model, b.layernorm, dev)}
    if b.kind == "attn":
        p.update(mod.attn_init(key, b.attn))
    elif b.kind == "mla":
        p.update(mod.mla_init(key, b.mla))
    elif b.kind == "mamba":
        p.update(M2.mamba2_init(key, b.mamba))
    elif b.kind == "rwkv":
        p.update(R6.rwkv6_init(key, b.rwkv))
    else:
        raise ValueError(b.kind)
    if b.cross_attn:
        p["ln_x"] = mod.norm_init(d_model, b.layernorm, dev)
        p["cross"] = mod.attn_init(key, b.attn)
    if b.post_norms:
        p["ln1_post"] = mod.norm_init(d_model, b.layernorm, dev)
    if b.mlp_kind != "none":
        p["ln2"] = mod.norm_init(d_model, b.layernorm, dev)
        if b.mlp_kind == "dense":
            p.update(mod.mlp_init(key, d_model, b.d_ff, b.gated))
        elif b.mlp_kind == "moe":
            p.update(mod.moe_init(key, b.moe))
        elif b.mlp_kind == "rwkv_cmix":
            p.update(R6.rwkv6_cmix_init(key, b.rwkv))
        else:
            raise ValueError(b.mlp_kind)
        if b.post_norms:
            p["ln2_post"] = mod.norm_init(d_model, b.layernorm, dev)
    return p


def init_params(key, cfg: ModelConfig, device="cuda"):
    """The parameter tree, f32, with the reference's paths, shapes and
    per-leaf scales. `key`: an int seed or a ``torch.Generator`` on
    `device` (the card unless the caller asks for the CPU);
    ``device="meta"`` gives the shapes alone and draws nothing."""
    dev = torch.device(device)
    if dev.type == "meta":
        key = None
    else:
        dev = target_device(dev)
        if not isinstance(key, torch.Generator):
            key = torch.Generator(device=dev).manual_seed(int(key))
    params: Dict[str, Any] = {}
    params.update(mod.embed_init(key, cfg.vocab_size, cfg.d_model))
    params["final_norm"] = mod.norm_init(cfg.d_model, cfg.layernorm, dev)
    params["units"] = [
        _stack([{f"b{i}": _block_init(key, b, cfg.d_model)
                 for i, b in enumerate(unit.blocks)}
                for _ in range(unit.repeat)])
        for unit in cfg.units]
    if cfg.shared_block is not None:
        params["shared"] = _block_init(key, cfg.shared_block, cfg.d_model)
    if cfg.encoder is not None:
        enc = cfg.encoder
        eb = _encoder_block(enc)
        params["encoder"] = {
            "layers": _stack([{"b0": _block_init(key, eb, cfg.d_model)}
                              for _ in range(enc.n_layers)]),
            "norm": mod.norm_init(cfg.d_model, True, dev),
            "pos": mod._normal(key, (enc.n_frames, cfg.d_model), 0.02),
        }
    return params


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _block_apply(bp, b: BlockSpec, h, positions, plan, aux, memory,
                 q_offset: int = 0):
    x = mod.norm_apply(bp["ln1"], h)
    if b.kind == "attn":
        y, _ = mod.attn_apply(bp, b.attn, x, positions, plan, q_offset)
    elif b.kind == "mla":
        y, _ = mod.mla_apply(bp, b.mla, x, positions, plan, q_offset)
    elif b.kind == "mamba":
        y, _ = M2.mamba2_apply(bp, b.mamba, x, plan)
    elif b.kind == "rwkv":
        y, _ = R6.rwkv6_apply(bp, b.rwkv, x, plan)
    else:
        raise ValueError(b.kind)
    if b.post_norms:
        y = mod.norm_apply(bp["ln1_post"], y)
    h = h + y
    if b.cross_attn and memory is not None:
        xc = mod.norm_apply(bp["ln_x"], h)
        h = h + mod.cross_attn_apply({"attn": bp["cross"]["attn"]}, b.attn,
                                     xc, memory, plan)
    if b.mlp_kind == "none":
        return h, aux
    x2 = mod.norm_apply(bp["ln2"], h)
    if b.mlp_kind == "dense":
        y2 = mod.mlp_apply(bp, x2, plan, b.act)
    elif b.mlp_kind == "moe":
        y2, a = mod.moe_apply(bp, b.moe, x2, plan)
        aux = aux + a
    elif b.mlp_kind == "rwkv_cmix":
        y2, _ = R6.rwkv6_cmix_apply(bp, b.rwkv, x2, plan)
    else:
        raise ValueError(b.mlp_kind)
    if b.post_norms:
        y2 = mod.norm_apply(bp["ln2_post"], y2)
    return h + y2, aux


def _unit_scan(uparams, unit: UnitSpec, cfg: ModelConfig, h, positions,
               plan, aux, shared_params, memory):
    def body(hh, ax, pslice):
        for bi, b in enumerate(unit.blocks):
            bp = shared_params if b.use_shared else pslice[f"b{bi}"]
            hh, ax = _block_apply(bp, b, hh, positions, plan, ax, memory)
        return hh, ax

    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for r in range(unit.repeat):
        pslice = _index(uparams, r)
        if remat:
            h, aux = checkpoint(body, h, aux, pslice, use_reentrant=False)
        else:
            h, aux = body(h, aux, pslice)
    return h, aux


def encode_frontend(params, cfg: ModelConfig, frames, plan):
    """Whisper encoder over precomputed (stub) frame embeddings."""
    enc = cfg.encoder
    h = (frames + params["encoder"]["pos"][None, :frames.shape[1]]
         ).to(mod.COMPUTE_DTYPE)
    eb = _encoder_block(enc)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    layers = params["encoder"]["layers"]
    for r in range(enc.n_layers):
        h, _ = _block_apply(_index(layers, r)["b0"], eb, h, None, plan, aux,
                            None)
    return mod.norm_apply(params["encoder"]["norm"], h)


_TOP = ("embed", "final_norm", "shared", "encoder")


def _whole_top(params, shards, keys=_TOP):
    """The top-level leaves under `keys` (those present): as they are, or
    gathered whole from the rank's shards."""
    return {k: params[k] if shards is None else shards.params(params[k], k)
            for k in keys if k in params}


def _whole_unit(params, ui: int, shards):
    up = params["units"][ui]
    return up if shards is None else shards.params(up, f"units/{ui}")


def forward_hidden(params, cfg: ModelConfig, tokens, plan: ShardingPlan,
                   positions=None, frontend=None):
    """tokens: (B, S_text). Returns (hidden (B,S,d), aux, text_offset)."""
    return _forward(params, cfg, tokens, plan, positions, frontend)[:3]


def _forward(params, cfg: ModelConfig, tokens, plan: ShardingPlan,
             positions=None, frontend=None, shards=None):
    """forward_hidden's (hidden, aux, text_offset) and the whole
    top-level leaves it used; `shards`: gather on use over a rank mesh
    (module docstring)."""
    top = _whole_top(params, shards)
    h = mod.embed_apply(top, tokens, plan,
                        scale=cfg.d_model ** 0.5 if cfg.embed_scale else None)
    memory = None
    offset = 0
    if cfg.encoder is not None and frontend is not None:
        memory = encode_frontend(top, cfg, frontend, plan)
    elif cfg.frontend == "vision" and frontend is not None:
        h = torch.cat([frontend.to(h.dtype), h], dim=1)
        offset = frontend.shape[1]
        h = plan.act_btd(h)
    S = h.shape[1]
    if positions is None:
        positions = torch.arange(S, device=h.device)[None, :]
        if cfg.mrope_sections is not None:
            positions = positions.expand((3,) + (h.shape[0], S))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for ui, unit in enumerate(cfg.units):
        h, aux = _unit_scan(_whole_unit(params, ui, shards), unit, cfg, h,
                            positions, plan, aux, top.get("shared"), memory)
    h = mod.norm_apply(top["final_norm"], h)
    return h, aux, offset, top


def lm_loss(params, cfg: ModelConfig, batch, plan: ShardingPlan,
            aux_weight: float = 0.01):
    """Next-token loss of `batch` ({"tokens", "labels"}, and "positions"
    or "frontend" where the arch takes them) -> (loss + aux_weight aux,
    {"xent", "aux"}); a vision prefix is sliced off before the loss."""
    h, aux, off = forward_hidden(params, cfg, batch["tokens"], plan,
                                 positions=batch.get("positions"),
                                 frontend=batch.get("frontend"))
    if off:
        h = h[:, off:]
    loss = mod.chunked_xent(params, h, batch["labels"], plan,
                            softcap=cfg.final_softcap)
    return loss + aux_weight * aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def _cache_len_for(b: BlockSpec, cache_len: int) -> int:
    if b.kind == "attn" and b.attn.window is not None:
        return min(b.attn.window, cache_len)      # ring buffer
    return cache_len


def _block_cache_init(b: BlockSpec, batch: int, cache_len: int, cfg,
                      dtype=torch.bfloat16, device="cuda", lead=()):
    """One block's cache leaves, each with the leading dims `lead` (the
    unit's repeat axis)."""
    zeros = lambda *s: torch.zeros(tuple(lead) + s, dtype=dtype,
                                   device=device)
    if b.kind == "mla":
        return {"c_kv": zeros(batch, cache_len, b.mla.kv_lora),
                "k_rope": zeros(batch, cache_len, b.mla.qk_rope)}
    if b.kind == "mamba":
        return M2.mamba2_cache_init(b.mamba, batch, dtype, device, lead)
    if b.kind == "rwkv":
        return R6.rwkv6_cache_init(b.rwkv, batch, dtype, device, lead)
    if b.kind != "attn":
        raise ValueError(b.kind)
    L = _cache_len_for(b, cache_len)
    K, D = b.attn.n_kv_heads, b.attn.head_dim
    c = {"k": zeros(batch, L, K, D), "v": zeros(batch, L, K, D)}
    if b.cross_attn:
        c["xk"] = zeros(batch, cfg.encoder.n_frames, K, D)
        c["xv"] = zeros(batch, cfg.encoder.n_frames, K, D)
    return c


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """The decode cache on `device` (the card unless the caller asks for
    the CPU; "meta" for shapes only): per unit, each block's leaves
    stacked on the repeat axis, and ``pos`` (batch,) int32."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = target_device(dev)
    units = [{f"b{i}": _block_cache_init(b, batch, cache_len, cfg, dtype,
                                         dev, (unit.repeat,))
              for i, b in enumerate(unit.blocks)} for unit in cfg.units]
    cache = {"units": units,
             "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.shared_block is not None:
        cache["shared"] = _block_cache_init(cfg.shared_block, batch,
                                            cache_len, cfg, dtype, dev)
    return cache


def _ring_update(cache_seq, new, pos):
    """Write (B,1,...) `new` at slot pos % L along axis 1."""
    return mod.masked_cache_write(cache_seq, new, pos % cache_seq.shape[1])


def _ring_slots(pos, L: int, window: Optional[int]):
    """(g, valid), each (B, L): the global position ring slot s holds at
    step pos, and whether the step attends it."""
    slots = torch.arange(L, device=pos.device)
    cur = pos[:, None] % L
    g = torch.where(slots[None] <= cur, pos[:, None] - cur + slots[None],
                    pos[:, None] - cur - L + slots[None])
    valid = (g >= 0) & (g > pos[:, None] - (window or L)) \
        & (g <= pos[:, None])
    return g, valid


def _attn_decode_windowed(bp, b: BlockSpec, x, pos, cache, plan):
    """Decode against a ring-buffer cache of W slots."""
    acfg = b.attn
    q, k_new, v_new = mod._qkv(bp, acfg, x, pos[..., None], plan)
    kc = _ring_update(cache["k"], k_new, pos)
    vc = _ring_update(cache["v"], v_new, pos)
    B, L, K, D = kc.shape
    H = acfg.n_heads
    G = H // K
    scale = acfg.query_scale if acfg.query_scale is not None else D ** -0.5
    _, valid = _ring_slots(pos, L, acfg.window)
    qg = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     kc.to(q.dtype).float()) * scale
    s = torch.where(valid[:, None, None, :], s, mod.NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(q.dtype),
                       vc.to(q.dtype)).reshape(B, 1, H, D)
    y = torch.einsum("bthk,hkd->btd", out, bp["attn"]["wo"].to(x.dtype))
    return plan.act_btd(y), {**cache, "k": kc, "v": vc}


def _block_decode(bp, b: BlockSpec, h, pos, cache, plan):
    x = mod.norm_apply(bp["ln1"], h)
    if b.kind == "mla":
        y, nc = mod.mla_decode(bp, b.mla, x, pos, cache, plan)
    elif b.kind == "mamba":
        y, nc = M2.mamba2_decode(bp, b.mamba, x, cache, plan)
    elif b.kind == "rwkv":
        y, nc = R6.rwkv6_decode(bp, b.rwkv, x,
                                {"sx": cache["sx"], "state": cache["state"]},
                                plan)
        nc = {**cache, **nc}
    elif b.kind != "attn":
        raise ValueError(b.kind)
    # the ring only when the cache was sized to the window
    elif b.attn.window is not None and cache["k"].shape[1] < 1 << 30 \
            and cache["k"].shape[1] <= b.attn.window:
        y, nc = _attn_decode_windowed(bp, b, x, pos, cache, plan)
    else:
        y, nc = mod.attn_decode(bp, b.attn, x, pos,
                                {"k": cache["k"], "v": cache["v"]}, plan)
        nc = {**cache, **nc}
    if b.post_norms:
        y = mod.norm_apply(bp["ln1_post"], y)
    h = h + y
    if b.cross_attn:
        xc = mod.norm_apply(bp["ln_x"], h)
        B, L, K, D = cache["xk"].shape
        H = b.attn.n_heads
        ap = bp["cross"]["attn"]
        qx = torch.einsum("btd,dhk->bthk", xc, ap["wq"].to(xc.dtype))[:, 0]
        qg = qx.reshape(B, K, H // K, D)
        s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                         cache["xk"].to(qx.dtype).float()) * D ** -0.5
        w = torch.softmax(s, -1)
        o = torch.einsum("bkgs,bskd->bkgd", w.to(qx.dtype),
                         cache["xv"].to(qx.dtype)).reshape(B, 1, H, D)
        h = h + torch.einsum("bthk,hkd->btd", o, ap["wo"].to(xc.dtype))
    if b.mlp_kind == "none":
        return h, nc
    x2 = mod.norm_apply(bp["ln2"], h)
    if b.mlp_kind == "dense":
        y2 = mod.mlp_apply(bp, x2, plan, b.act)
    elif b.mlp_kind == "moe":
        y2, _ = mod.moe_apply(bp, b.moe, x2, plan)
    elif b.mlp_kind == "rwkv_cmix":
        y2, last = R6.rwkv6_cmix_apply(bp, b.rwkv, x2, plan,
                                       last=cache.get("sx_cmix"))
        nc = {**nc, "sx_cmix": last}
    else:
        raise ValueError(b.mlp_kind)
    if b.post_norms:
        y2 = mod.norm_apply(bp["ln2_post"], y2)
    return h + y2, nc


def serve_decode(params, cfg: ModelConfig, token, cache,
                 plan: ShardingPlan, shards=None):
    """One decode step. token: (B,) int32; cache from init_cache.

    Returns (logits (B, vocab), new_cache); `cache` is left as it was.
    With `shards` (module docstring) `token`, the logits and ``pos`` are
    the rank's rows, and the cache's unit leaves the rank's slices."""
    pos = cache["pos"]
    top = _whole_top(params, shards, ("embed", "final_norm", "shared"))
    h = mod.embed_apply(top, token[:, None], plan,
                        scale=cfg.d_model ** 0.5 if cfg.embed_scale else None)
    new_units = []
    for ui, unit in enumerate(cfg.units):
        uparams = _whole_unit(params, ui, shards)
        ucache = cache["units"][ui]
        if shards is not None:
            ucache = shards.cache(ucache, f"units/{ui}")
        per_repeat = []
        for r in range(unit.repeat):
            pslice = _index(uparams, r)
            cslice = _index(ucache, r)
            ncs = {}
            for bi, b in enumerate(unit.blocks):
                bp = top["shared"] if b.use_shared else pslice[f"b{bi}"]
                h, ncs[f"b{bi}"] = _block_decode(bp, b, h, pos,
                                                 cslice[f"b{bi}"], plan)
            per_repeat.append(ncs)
        new = _stack(per_repeat)
        del uparams, ucache
        new_units.append(new if shards is None
                         else shards.keep(new, f"units/{ui}"))
    h = mod.norm_apply(top["final_norm"], h)
    logits = mod.unembed_logits(top, h, plan, cfg.final_softcap)[:, 0]
    new_cache = {**cache, "units": new_units, "pos": pos + 1}
    return logits, new_cache


def serve_prefill(params, cfg: ModelConfig, tokens, plan: ShardingPlan,
                  frontend=None, shards=None):
    """Prefill: full forward returning last-position logits (cache writing
    is elided, as in the reference: the prefill compute path alone).
    With `shards` (module docstring) `tokens` and the logits are the
    rank's rows."""
    h, _, _, top = _forward(params, cfg, tokens, plan, frontend=frontend,
                            shards=shards)
    logits = mod.unembed_logits(top, h[:, -1:], plan, cfg.final_softcap)
    return logits[:, 0]
