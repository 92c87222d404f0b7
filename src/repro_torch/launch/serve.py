"""Serving entry points of the port (``src/repro/launch/serve.py``):
prefill and decode callables with their argument structs and cache
shardings, and the startup restore of a compressed checkpoint.

Decode-time placement (the reference's specs): KV/cache SEQUENCE dims
are sharded over the model axis (context parallelism), batch over the
DP axes; SSM states shard heads over model. For a batch the DP size does
not divide the cache sequence shards over (data, model) jointly and
batch stays replicated (``decode_wide``).

Over a RANK mesh (one process a position, ``launch/mesh.py``) the
restore and the pager keep each rank's PARAM_RULES shard of every leaf,
:func:`init_serving_cache` gives the rank's ``cache_shardings`` slices,
and the callables are rank-aware: they take the global tokens, run the
one-device arithmetic on the rank's batch rows (every row under
``decode_wide``) with each unit's parameters and cache leaves gathered
whole on use (:class:`ServeShards`), keep the rank's slice of every
updated cache leaf, and return the global logits, gathered over the
batch group in batch order, as the reference's jitted callables return
global arrays. On a logical mesh (one process, one device) and without
a mesh the callables run the whole batch on that device.

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

from ..convert import map_tree, tree_items
from ..models import transformer as T
from ..runtime.dist import gather_cat
from ..runtime.fused import target_device
from ..runtime.sharding import NamedSharding, PartitionSpec as P
from ..runtime.sharding import (ShardingPlan, gather_leaf, is_rank_plan,
                                leaf_sharding, plan_device, shard_slices)


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
    batched decode on the plan's device (`device` without a mesh) ->
    serving-dtype cast (host, per leaf) -> placement.

    Every leaf is placed as it decodes: by its PARAM_RULES sharding on
    the plan's mesh (on a rank mesh each rank decodes the stream on its
    own device and keeps its shard), or on `device` without a mesh (the
    card unless the caller asks for the CPU), so the serving tree never
    exists in f32 on the device.

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
    dev = target_device(plan_device(plan, "restore_serving_params")
                        or device)
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
    bit-identical to a full restore. On a rank mesh every rank opens the
    store (its pins and swaps are collective, ``serve/paging.py``) and
    decodes on its own device.
    """
    from ..checkpoint import ckpt as C
    from ..serve.paging import PagedParamStore
    device = plan_device(plan, "paged_serving_store") or device
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


def _batch_ok(plan: ShardingPlan, batch: int) -> bool:
    """Whether the DP size divides `batch` (else ``decode_wide``)."""
    return plan.mesh is None or batch % int(np.prod(
        [plan.axis_size(a) for a in plan.batch_axes])) == 0


class ServeShards:
    """Gather on use for serving over a rank mesh: the models' `shards`
    (``models/transformer.py``). `param` maps every parameter path to its
    PARAM_RULES sharding, `cache_shd` every path of `cache_struct` (a
    decode cache's meta tree; None for prefill) to its
    ``cache_shardings`` one; `rows_part` is the spec part of a cache
    leaf's batch dimension (None under ``decode_wide``: every rank holds
    every row)."""

    def __init__(self, model_cfg, plan: ShardingPlan, cache_struct=None,
                 batch_sharded: bool = True):
        meta = T.init_params(0, model_cfg, device="meta")
        self.param = {k: leaf_sharding(k, tuple(v.shape), plan)
                      for k, v in tree_items(meta)}
        self.cache_shd = {} if cache_struct is None else dict(tree_items(
            cache_shardings(cache_struct, plan, batch_sharded=batch_sharded)))
        self.rows_part = plan.batch if batch_sharded else None

    def slice_dims(self, sharding):
        """A cache leaf's split dimensions but its batch rows."""
        return [i for i, p in enumerate(sharding.spec)
                if p is not None and p != self.rows_part]

    def params(self, tree, prefix: str):
        """The rank's shards under `prefix` gathered whole."""
        return map_tree(lambda k, v: gather_leaf(v, self.param[k]), tree,
                        prefix + "/")

    def cache(self, tree, prefix: str):
        """The rank's cache slices under `prefix` gathered whole over every
        dimension but the batch rows: the rank's rows of each leaf."""
        def whole(k, v):
            sh = self.cache_shd[k]
            return gather_leaf(v, sh, self.slice_dims(sh))
        return map_tree(whole, tree, prefix + "/")

    def keep(self, tree, prefix: str):
        """The inverse of :meth:`cache`: the rank's slice of each of its
        rows' updated leaves, as a tensor of its own."""
        def cut(k, v):
            sh = self.cache_shd[k]
            dims = self.slice_dims(sh)
            if not dims:
                return v
            return v[shard_slices(tuple(v.shape), sh, dims=dims)].clone(
                memory_format=torch.contiguous_format)
        return map_tree(cut, tree, prefix + "/")


def _rows(plan: ShardingPlan, batch: int, batch_ok: bool):
    """(lo, hi): the rank's block of the global batch (every row when the
    DP size does not divide it)."""
    if not batch_ok:
        return 0, batch
    index, size = plan.batch_index()
    per = batch // size
    return index * per, (index + 1) * per


def init_serving_cache(model_cfg, plan: ShardingPlan, batch: int,
                       cache_len: int, dtype=torch.bfloat16,
                       device="cuda"):
    """The empty decode cache of :func:`make_decode_fn`'s callable: on a
    rank mesh the rank's ``cache_shardings`` slice of every leaf of
    ``init_cache`` (zeros made at the slice's shape on the rank's device;
    ``pos`` whole), else ``init_cache`` on the plan's device (`device`
    without a mesh)."""
    if not is_rank_plan(plan):
        return T.init_cache(model_cfg, batch, cache_len, dtype,
                            device=plan_device(plan, "a serving cache")
                            or device)
    struct = T.init_cache(model_cfg, batch, cache_len, dtype, device="meta")
    ok = _batch_ok(plan, batch)
    shd = dict(tree_items(cache_shardings(
        struct, dataclasses.replace(plan, decode_wide=not ok),
        batch_sharded=ok)))
    dev = target_device(plan.mesh.local_device)

    def zeros(k, v):
        cut = shard_slices(tuple(v.shape), shd[k])
        return torch.zeros(tuple(c.stop - c.start for c in cut),
                           dtype=v.dtype, device=dev)
    return map_tree(zeros, struct)


def make_decode_fn(model_cfg, plan: ShardingPlan, batch: int, cache_len: int):
    """Returns (fn, token_struct, cache_struct, (token_sharding,
    cache_shardings)); fn(params, token, cache) -> (logits, new_cache).
    On a rank mesh (module docstring) `params` are the rank's shards,
    `token` (batch,) and the logits global, the cache the rank's slices
    (:func:`init_serving_cache`)."""
    cache_struct = T.init_cache(model_cfg, batch, cache_len, device="meta")
    token_struct = torch.empty((batch,), dtype=torch.int32, device="meta")

    batch_ok = _batch_ok(plan, batch)
    plan = dataclasses.replace(plan, decode_wide=not batch_ok)

    if is_rank_plan(plan):
        shards = ServeShards(model_cfg, plan, cache_struct, batch_ok)
        lo, hi = _rows(plan, batch, batch_ok)
        group = plan.batch_group()

        def decode(params, token, cache):
            mine = {**cache, "pos": cache["pos"][lo:hi]}
            logits, new = T.serve_decode(params, model_cfg, token[lo:hi],
                                         mine, plan, shards=shards)
            if batch_ok:
                logits = gather_cat(logits, group, 0)
            return logits, {**new, "pos": cache["pos"] + 1}
    else:
        def decode(params, token, cache):
            return T.serve_decode(params, model_cfg, token, cache, plan)
    cs = cache_shardings(cache_struct, plan, batch_sharded=batch_ok)
    ts = (NamedSharding(plan.mesh, P(plan.batch if batch_ok else None))
          if plan.mesh else None)
    return decode, token_struct, cache_struct, (ts, cs)


def make_prefill_fn(model_cfg, plan: ShardingPlan, batch: int, seq: int):
    """Returns (fn, ordered_arg_structs, ordered_arg_shardings) where the
    structs follow fn's positional order after params: (tokens[,
    frontend]). On a rank mesh (module docstring) the arguments and the
    logits are global, `params` the rank's shards; a batch the DP size
    does not divide runs whole on every rank."""
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

    if is_rank_plan(plan):
        batch_ok = _batch_ok(plan, batch)
        rank_plan = dataclasses.replace(plan, decode_wide=not batch_ok)
        shards = ServeShards(model_cfg, rank_plan)
        lo, hi = _rows(rank_plan, batch, batch_ok)
        group = rank_plan.batch_group()

        def prefill(params, tokens, frontend=None):
            logits = T.serve_prefill(
                params, model_cfg, tokens[lo:hi], rank_plan,
                frontend=None if frontend is None else frontend[lo:hi],
                shards=shards)
            return gather_cat(logits, group, 0) if batch_ok else logits
    else:
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


__all__ = ["ServeShards", "cache_shardings", "init_serving_cache",
           "make_decode_fn", "make_prefill_fn", "paged_serving_store",
           "restore_serving_params", "serving_params_struct"]
