"""Sharding plan: one object that tells every layer how to place tensors
(the port of ``src/repro/runtime/sharding.py``).

Axes convention (the production mesh of launch/mesh.py):
  * `pod`   — slow inter-pod axis: pure data parallelism + the axis the
              compressed gradient reduction runs over.
  * `data`  — intra-pod data parallelism; also hosts ZeRO-1 optimizer-
              state sharding and context parallelism for long sequences.
  * `model` — tensor parallelism: attention heads, FFN hidden, vocab,
              MoE experts, and the KV-cache sequence dim at decode.

The rules (:data:`PARAM_RULES`, :func:`spec_for_path`,
:func:`leaf_sharding`) are the reference's, over the port's flat
``dict[str, Tensor]`` trees keyed by '/'-joined paths. Placement runs on a
mesh that spans ONE device (every axis of size 1, or a logical mesh that
names one device on every position): :func:`place` moves a leaf there,
:func:`shard_compress` and ``CEAZ.compress_batch`` run their passes
there. A mesh over several devices raises NotImplementedError:
placement across cards comes with training and ``torch.distributed``
(ROADMAP Queue 1 item 5). A plan with mesh=None makes every helper a
no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..launch.mesh import Mesh

class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array (None: replicated), as jax's
    ``PartitionSpec``: ``P('model', None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the spec that lays one array out over it."""
    mesh: Mesh
    spec: PartitionSpec


def _multi_device(what: str, mesh: Mesh):
    raise NotImplementedError(
        f"{what} over a mesh of {len(mesh.device_set)} devices "
        f"({list(mesh.device_set)}) is not ported to repro_torch yet "
        "(ROADMAP Queue 1 item 5: placement across cards comes with "
        "training and torch.distributed)")


def mesh_device(mesh: Mesh, what: str = "placement") -> torch.device:
    """The one device a mesh spans; NotImplementedError naming Queue 1
    item 5 for a mesh over several devices."""
    devs = mesh.device_set
    if len(devs) != 1:
        _multi_device(what, mesh)
    return devs[0]


def plan_device(plan, what: str) -> Optional[torch.device]:
    """The device a plan's mesh spans, or None without a plan or mesh."""
    mesh = getattr(plan, "mesh", None) if plan is not None else None
    return None if mesh is None else mesh_device(mesh, what)


@dataclasses.dataclass
class ShardingPlan:
    mesh: Optional[Mesh] = None
    batch_axes: Tuple[str, ...] = ("data",)   # ('pod','data') when multi-pod
    model_axis: str = "model"
    # axis used for ZeRO/FSDP extra param sharding and context parallelism
    zero_axis: str = "data"
    # TP placement for attention activations/weights: shard the heads dim
    # when n_heads % model_size == 0, else shard head_dim
    attn_part: str = "heads"                  # 'heads' | 'head_dim'
    # decode cache layout: wide=True shards the cache SEQUENCE dim over
    # (batch axes + model) and leaves batch unsharded
    decode_wide: bool = False

    def cache_kv_spec(self):
        """(batch, seq, ...) spec parts for decode caches."""
        if self.decode_wide:
            return None, tuple(self.batch_axes) + (self.model_axis,)
        return self.batch, self.model_axis

    # -- helpers -------------------------------------------------------------
    @property
    def batch(self):
        return self.batch_axes if len(self.batch_axes) > 1 \
            else self.batch_axes[0]

    def axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape[name]

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis) if self.mesh else 1

    def spec(self, *parts) -> PartitionSpec:
        return P(*parts)

    def cs(self, x, *parts):
        """The sharding constraint: the identity without a mesh or on a
        mesh that spans one device."""
        if self.mesh is not None:
            mesh_device(self.mesh, "a sharding constraint")
        return x

    def named(self, *parts) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, P(*parts))

    # activation conventions ---------------------------------------------------
    def act_btd(self, x):
        """(batch, seq, d_model): batch over DP axes, d replicated."""
        return self.cs(x, self.batch, None, None)

    def act_bthd(self, x):
        """(batch, seq, heads, head_dim): TP over heads or head_dim."""
        if self.attn_part == "heads":
            return self.cs(x, self.batch, None, self.model_axis, None)
        return self.cs(x, self.batch, None, None, self.model_axis)

    def act_btf(self, x):
        """(batch, seq, ffn_hidden): hidden over model axis."""
        return self.cs(x, self.batch, None, self.model_axis)

    def logits_btv(self, x):
        """(batch, seq, vocab): vocab over model axis."""
        return self.cs(x, self.batch, None, self.model_axis)


def shard_compress(x: np.ndarray, plan: ShardingPlan,
                   eb_rel: float = 1e-4, chunk_values: int = 1 << 20,
                   block_size: int = 4096, device="cuda"):
    """Shard-parallel fused compression of one large array.

    Cuts `x` along its leading axis into one shard per position of the
    plan's batch axes (a single shard without a mesh) and compresses them
    through one pair of fused passes — each shard an independent CEAZ
    stream. Returns (compressed_list, shard_len), shard_len being the
    leading-axis extent of every shard but possibly the last; a ragged
    tail takes its own pass. The passes run on the device the plan's
    mesh spans, else on `device` (the card unless the caller asks for
    the CPU); a mesh over several devices raises NotImplementedError.
    """
    from ..core.codebook import default_offline_codebook
    from . import fused
    if x.shape[0] == 0:
        raise ValueError("shard_compress needs a non-empty leading axis")
    dev = plan_device(plan, "shard_compress") or device
    n_dev = int(np.prod([plan.axis_size(a) for a in plan.batch_axes])) \
        if plan.mesh is not None else 1
    n_dev = max(1, min(n_dev, x.shape[0]))
    per = -(-x.shape[0] // n_dev)
    shards = [x[s:s + per] for s in range(0, x.shape[0], per)]
    off = default_offline_codebook()
    run = lambda grp: fused.batch_compress(grp, eb_rel, chunk_values,
                                           block_size, off, device=dev)
    if len({s.shape for s in shards}) > 1:      # ragged tail: pad-free split
        comps = run(shards[:-1]) + run(shards[-1:])
    else:
        comps = run(shards)
    return comps, per


def make_plan(mesh: Optional[Mesh]) -> ShardingPlan:
    if mesh is None:
        return ShardingPlan(mesh=None)
    axes = tuple(mesh.axis_names)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes) \
        or (axes[0],)
    return ShardingPlan(mesh=mesh, batch_axes=batch_axes)


# ---------------------------------------------------------------------------
# Parameter sharding rules: map param-tree paths to PartitionSpecs
# (the reference's table, verbatim).
# ---------------------------------------------------------------------------

PARAM_RULES: Sequence[Tuple[str, Tuple]] = (
    # (path substring, partition parts) — first match wins. None = replicate.
    # 'ATTN'/'ATTN_T' resolve per plan.attn_part (heads vs head_dim TP).
    ("embed/table", ("model", None)),           # vocab-sharded embeddings
    ("attn/wq", (None, "ATTN_H", "ATTN_D")),    # (d, heads, head_dim)
    ("attn/wk", (None, "ATTN_H", "ATTN_D")),
    ("attn/wv", (None, "ATTN_H", "ATTN_D")),
    ("attn/wo", ("ATTN_H", "ATTN_D", None)),    # (heads, head_dim, d)
    ("mla/wq_a", (None, None)),
    ("mla/wq_b", (None, "model", None)),
    ("mla/wkv_a", (None, None)),
    ("mla/wkv_b", (None, "model", None)),
    ("mla/wo", ("model", None, None)),
    ("mlp/wi", (None, "model")),                # (d, ff)
    ("mlp/wg", (None, "model")),
    ("mlp/wo", ("model", None)),                # (ff, d)
    ("moe/router", (None, None)),
    # experts: EP over model + FSDP over data (gathered per layer in the
    # scan; without the data factor DeepSeek-236B cannot fit 16 GB/chip)
    ("moe/wi", ("model", "data", None)),        # (E, d, ff)
    ("moe/wg", ("model", "data", None)),
    ("moe/wo", ("model", "data", None)),        # (E, ff, d)
    ("ssm/wi_z", (None, "model")),              # mamba z/x: col-parallel
    ("ssm/wi_x", (None, "model")),
    ("ssm/wi_", (None, None)),                  # B/C/dt streams: replicated
    ("ssm/wi", (None, "model")),                # rwkv-style fused in-proj
    ("ssm/wo", ("model", None)),                # mamba/rwkv out-proj (row)
    ("ssm/conv_x_w", (None, "model")),
    ("ssm/conv_x_b", ("model",)),
    ("ssm/conv", (None, None)),                 # B/C convs: replicated
    ("ssm/wr", (None, "model")),                # rwkv projections
    ("ssm/wk", (None, "model")),
    ("ssm/wv", (None, "model")),
    ("ssm/wg", (None, "model")),
    ("ssm_cmix/wk", (None, "model")),
    ("ssm_cmix/wv", ("model", None)),
    ("ssm_cmix/wr", (None, "model")),
    ("ssm/", (None,)),                          # other ssm leaves: replicate
    ("norm", (None,)),
    ("", (None,)),                              # default: replicate
)


def _resolve(parts, attn_part: str):
    out = []
    for p in parts:
        if p == "ATTN_H":
            out.append("model" if attn_part == "heads" else None)
        elif p == "ATTN_D":
            out.append("model" if attn_part == "head_dim" else None)
        else:
            out.append(p)
    return tuple(out)


def spec_for_path(path: str, ndim: int,
                  attn_part: str = "heads") -> PartitionSpec:
    for pat, parts in PARAM_RULES:
        if pat in path:
            parts = _resolve(parts, attn_part)
            if len(parts) < ndim:           # stacked (scanned) leading dims
                parts = (None,) * (ndim - len(parts)) + parts
            elif len(parts) > ndim:
                parts = parts[-ndim:] if ndim else ()
            return P(*parts)
    return P(*([None] * ndim))


def leaf_sharding(path: str, shape,
                  plan: ShardingPlan) -> Optional[NamedSharding]:
    """NamedSharding for ONE leaf by PARAM_RULES path match, or None when
    the plan has no mesh. Needs only the flat key path and shape, so a
    streaming restore can place each leaf as it decodes."""
    if plan.mesh is None:
        return None
    shape = tuple(shape)
    spec = spec_for_path(path, len(shape), plan.attn_part)
    # divisibility guard: a dim that does not divide its axes' size
    # (e.g. GQA kv-heads=2 over a 16-way model axis) is replicated
    parts = []
    for i, p in enumerate(spec):
        if p is None:
            parts.append(None)
            continue
        axes = p if isinstance(p, tuple) else (p,)
        size = int(np.prod([plan.mesh.shape[a] for a in axes]))
        parts.append(p if shape[i] % size == 0 else None)
    return NamedSharding(plan.mesh, P(*parts))


def param_shardings(params, plan: ShardingPlan):
    """{path: NamedSharding or None} for a flat or nested tree (paths in
    ``convert.tree_items`` order)."""
    from ..convert import tree_items
    return {k: leaf_sharding(k, tuple(getattr(v, "shape", ())), plan)
            for k, v in tree_items(params)}


def place(arr, sharding: Optional[NamedSharding]):
    """A host leaf (numpy array or tensor) as a tensor on the device its
    sharding's mesh spans; with no sharding, the leaf unchanged. A mesh
    over several devices raises NotImplementedError (Queue 1 item 5)."""
    from .fused import target_device
    if sharding is None:
        return arr
    dev = target_device(mesh_device(sharding.mesh, "placement"))
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.asarray(arr, order="C"))
    return torch.as_tensor(arr).to(dev)
