"""Serving entry points of the port (``src/repro/launch/serve.py``):
prefill and decode callables with their argument structs and cache
shardings, and the startup restore of a compressed checkpoint.

Decode-time placement (the reference's specs): KV/cache SEQUENCE dims
are sharded over the model axis (context parallelism), batch over the
DP axes; SSM states shard heads over model. For a batch smaller than
the DP size the cache sequence shards over (data, model) jointly and
batch stays replicated. The port serves on one device (a logical mesh
on it); serving over several devices — a rank mesh of several
processes, cache placement by ``cache_shardings``, the restore and the
pager onto it — raises NotImplementedError (ROADMAP Queue 1 item 5c;
training over several devices is ported, ``launch/train.py``).

The callables are plain eager functions: no ``torch.compile`` and no
CUDA graph. Argument structs are meta tensors, standing where the
reference has ``jax.ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..convert import map_tree
from ..models import transformer as T
from ..runtime.fused import target_device
from ..runtime.sharding import NamedSharding, PartitionSpec as P
from ..runtime.sharding import ShardingPlan, serving_device


def _seq_axes(plan: ShardingPlan, wide: bool):
    """Axis (tuple) for cache sequence dims."""
    if wide:
        return tuple(plan.batch_axes) + (plan.model_axis,)
    return plan.model_axis


def cache_shardings(cache, plan: ShardingPlan, batch_sharded: bool = True):
    """Tree of NamedShardings for a serve cache (see module docstring);
    None at every leaf without a mesh."""
    if plan.mesh is None:
        return map_tree(lambda _p, _l: None, cache)
    wide = not batch_sharded
    bat = plan.batch if batch_sharded else None
    msize = plan.model_size

    def leaf_spec(keys, leaf) -> P:
        nd = len(leaf.shape)
        name = keys.split("/")[-1]
        shape = leaf.shape
        if name == "pos":
            return P()
        if name in ("k", "v"):               # (R, B, L, K, D)
            L = shape[-3]
            dp = int(np.prod([plan.axis_size(a) for a in plan.batch_axes]))
            parts = [None] * nd
            parts[-4] = bat
            if wide and L % (msize * dp) == 0:
                parts[-3] = _seq_axes(plan, True)
            elif L % msize == 0:
                parts[-3] = plan.model_axis
            return P(*parts)
        if name in ("xk", "xv"):             # (R, B, F, K, D) cross-attn
            parts = [None] * nd
            parts[-4] = bat
            return P(*parts)
        if name in ("c_kv", "k_rope"):       # (R, B, S, c) MLA's latent
            parts = [None] * nd
            parts[-3] = bat
            if shape[-2] % msize == 0:
                parts[-2] = plan.model_axis
            return P(*parts)
        if name == "conv":                   # (R, B, K-1, C) mamba
            parts = [None] * nd
            parts[-3] = bat
            if shape[-1] % msize == 0:
                parts[-1] = plan.model_axis
            return P(*parts)
        if name == "state":                  # (R, B, H, P, N|P) SSM state
            parts = [None] * nd
            parts[-4] = bat
            if shape[-3] % msize == 0:
                parts[-3] = plan.model_axis
            return P(*parts)
        if name in ("sx", "sx_cmix"):        # (R, B, d) rwkv token shifts
            parts = [None] * nd
            parts[-2] = bat
            return P(*parts)
        return P(*([None] * nd))

    return map_tree(
        lambda p, l: NamedSharding(plan.mesh, leaf_spec(p, l)), cache)


def _serving_cast(dtype):
    """Per-leaf host-side cast to the serving dtype: applied BEFORE
    device placement so only one leaf ever exists in both precisions —
    startup peak device memory is the serving (bf16) footprint, not
    f32+bf16. A float leaf (numpy array, or CPU tensor for bfloat16 and
    float8) becomes a CPU tensor of `dtype`; any other leaf passes
    through."""
    def cast(key, arr):
        if isinstance(arr, np.ndarray) and np.issubdtype(arr.dtype,
                                                         np.floating):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        if isinstance(arr, torch.Tensor) and arr.is_floating_point() \
                and arr.dtype != dtype:
            return arr.to(dtype)
        return arr
    return cast


def _serving_step_dir(directory: str, step: Optional[int]):
    """(step_dir, step) of the newest usable checkpoint (or `step`)."""
    from ..checkpoint import ckpt as C
    steps = C.available_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    if not steps:
        return None
    s = steps[-1]
    return os.path.join(directory, f"step_{s:08d}"), s


def _as_tensor(arr, device):
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    return arr.to(device) if isinstance(arr, torch.Tensor) else arr


def restore_serving_params(directory: str, plan: ShardingPlan,
                           step: Optional[int] = None, ckpt_cfg=None,
                           dtype=torch.bfloat16, paged: bool = False,
                           device="cuda", **paged_kw):
    """Startup restore for serving: checkpoint leaf stream -> engine-fed
    batched decode on `device` -> serving-dtype cast (host, per leaf) ->
    placement.

    Every leaf is placed as it decodes: by its PARAM_RULES sharding on
    the plan's mesh (one device; several raise NotImplementedError,
    ROADMAP Queue 1 item 5c), or
    on `device` without a mesh (the card unless the caller asks for the
    CPU), so the serving tree never exists in f32 on the device.

    With `paged=True` the full restore is skipped entirely: returns
    ``(PagedParamStore, meta)`` (see `paged_serving_store`, which also
    takes `paged_kw` like ``cache_bytes``). Otherwise returns (params,
    meta). None when no usable checkpoint exists.
    """
    if paged:
        return paged_serving_store(directory, plan, step=step,
                                   ckpt_cfg=ckpt_cfg, dtype=dtype,
                                   device=device, **paged_kw)
    from ..checkpoint import ckpt as C
    serving_device(plan, "restore_serving_params")
    dev = target_device(device)
    cast = _serving_cast(dtype)
    if plan.mesh is None:
        transform = lambda key, arr: _as_tensor(cast(key, arr), dev)
    else:
        transform = lambda key, arr: _as_tensor(cast(key, arr), "cpu")
    restored = C.restore_checkpoint(directory, step=step, plan=plan,
                                    cfg=ckpt_cfg, leaf_transform=transform,
                                    device=dev)
    if restored is None:
        return None
    state, meta = restored
    params = (state["params"] if isinstance(state, dict)
              and "params" in state else state)
    return params, meta


def paged_serving_store(directory: str, plan: ShardingPlan,
                        step: Optional[int] = None, ckpt_cfg=None,
                        dtype=torch.bfloat16, device="cuda", **paged_kw):
    """Open the newest usable checkpoint as a decode-on-demand
    :class:`~repro_torch.serve.paging.PagedParamStore` (compressed-
    resident weights; layers decode on first touch with the
    serving-dtype cast and placement fused in). Extra `paged_kw` forward
    to the store (``cache_bytes``, ``group``, ...).

    Returns (store, meta) or None when no usable checkpoint exists (the
    reason is printed, as in the reference). The store's decode facade
    mirrors `restore_checkpoint`'s compressor config, so paged leaves are
    bit-identical to a full restore.
    """
    from ..checkpoint import ckpt as C
    from ..serve.paging import PagedParamStore
    found = _serving_step_dir(directory, step)
    if found is None:
        return None
    d, s = found
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format", 1) < 2:
            raise ValueError("paged serving needs a format-2 leaf stream")
        stream = os.path.join(d, manifest.get("file", C.LEAVES_STREAM))
        cfg = ckpt_cfg or C.CheckpointConfig()
        keys = list(manifest.get("leaves", {}))
        prefix = "params/" if any(
            k.startswith("params/") for k in keys) else None
        store = PagedParamStore(stream, plan=plan, dtype=dtype,
                                comp=C._compressor(cfg, device),
                                prefix=prefix, device=device, **paged_kw)
    except Exception as e:
        print(f"checkpoint {d} unusable for paged serving ({e})")
        return None
    return store, {"step": manifest.get("step", s),
                   **manifest.get("extra", {})}


def _meta_like(tree, dtype=None):
    return map_tree(
        lambda _p, l: torch.empty(tuple(l.shape), dtype=dtype or l.dtype,
                                  device="meta"), tree)


def serving_params_struct(model_cfg):
    """Serving holds params in bf16: re-reading and casting f32 masters
    every decode step doubles parameter traffic for nothing. -> the
    parameter tree as bf16 meta tensors."""
    return _meta_like(T.init_params(0, model_cfg, device="meta"),
                      torch.bfloat16)


def make_decode_fn(model_cfg, plan: ShardingPlan, batch: int, cache_len: int):
    """Returns (fn, token_struct, cache_struct, (token_sharding,
    cache_shardings)); fn(params, token, cache) -> (logits, new_cache)."""
    cache_struct = T.init_cache(model_cfg, batch, cache_len, device="meta")
    token_struct = torch.empty((batch,), dtype=torch.int32, device="meta")

    batch_ok = plan.mesh is None or batch % int(np.prod(
        [plan.axis_size(a) for a in plan.batch_axes])) == 0
    plan = dataclasses.replace(plan, decode_wide=not batch_ok)

    def decode(params, token, cache):
        return T.serve_decode(params, model_cfg, token, cache, plan)
    cs = cache_shardings(cache_struct, plan, batch_sharded=batch_ok)
    ts = (NamedSharding(plan.mesh, P(plan.batch if batch_ok else None))
          if plan.mesh else None)
    return decode, token_struct, cache_struct, (ts, cs)


def make_prefill_fn(model_cfg, plan: ShardingPlan, batch: int, seq: int):
    """Returns (fn, ordered_arg_structs, ordered_arg_shardings) where the
    structs follow fn's positional order after params: (tokens[,
    frontend])."""
    text = seq
    structs: Dict[str, Any] = {}
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    if model_cfg.frontend == "vision":
        text = seq - model_cfg.frontend_len
        structs["frontend"] = meta(
            (batch, model_cfg.frontend_len, model_cfg.d_model), torch.float32)
    elif model_cfg.frontend == "audio":
        structs["frontend"] = meta(
            (batch, model_cfg.encoder.n_frames, model_cfg.d_model),
            torch.float32)
    structs = {"tokens": meta((batch, text), torch.int32), **structs}

    def prefill(params, tokens, frontend=None):
        return T.serve_prefill(params, model_cfg, tokens, plan,
                               frontend=frontend)

    args = [structs["tokens"]] + (
        [structs["frontend"]] if "frontend" in structs else [])
    shardings = tuple(
        (NamedSharding(plan.mesh,
                       P(plan.batch, *([None] * (len(v.shape) - 1))))
         if plan.mesh else None) for v in args)
    return prefill, args, shardings


__all__ = ["cache_shardings", "make_decode_fn", "make_prefill_fn",
           "paged_serving_store", "restore_serving_params",
           "serving_params_struct"]
