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
``dict[str, Tensor]`` trees keyed by '/'-joined paths, with its
divisibility guard.

Placement follows the mesh (``launch/mesh.py``):

  * a RANK mesh (built inside a ``torch.distributed`` world, one process
    a position): :func:`place` keeps the rank's local shard of a leaf —
    the slice its mesh coordinates select along every dimension the spec
    names — on the rank's device, and :func:`gather_leaf` all-gathers the
    shards back to the whole leaf (``runtime/dist.py``, gloo, staged
    through the host). :func:`shard_compress`, ``fused.batch_compress``
    and ``CEAZ.compress_batch`` compress the shards at each batch
    position on that position's rank and all-gather the streams as
    objects, so every rank returns ``plan=None``'s list bit for bit;
  * a LOGICAL mesh (one process, every position naming one device):
    whole leaves on that device, the passes there;
  * ``mesh=None``: every helper a no-op.

One process cannot drive a mesh whose positions name several devices:
:func:`mesh_device` raises ValueError for it.

Compute on the model axis is gather on use. The reference's model code
fixes where each leaf lives, not how the model axis splits the
arithmetic (XLA decides that). The port's train step gathers every
stored shard to the whole leaf and computes exactly the one-device step
on its batch rows; the arithmetic is split only where the reference
splits it by hand: MoE expert parallelism (``models/modules.py::
moe_apply``) and the pod exchange (``optim/grad_compress.py``).
Megatron-style split matmuls would change the order of every sum for no
check that can be made against the reference.

Serving over a rank mesh follows the same rule (``launch/serve.py``):
parameters rest as shards, and each decode cache leaf as the rank's
slice by ``cache_shardings`` (:func:`place_cache`; the sequence of a
``decode_wide`` cache over two axes at once). Prefill and decode gather
a unit's parameters and its cache leaves whole on use (a cache over
every dimension but its batch rows: :func:`gather_leaf` with `dims`),
compute the one-device step on the rank's rows and keep the rank's
slice of each updated leaf (:func:`shard_slices` with `dims`).
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


def mesh_device(mesh: Mesh, what: str = "placement") -> torch.device:
    """The device this process computes on for `mesh`: the rank's own on
    a rank mesh, the one device a logical mesh names. A mesh whose
    positions name several devices in one process raises ValueError:
    the port runs one process a position."""
    if mesh.is_rank_mesh:
        return mesh.local_device
    devs = mesh.device_set
    if len(devs) != 1:
        raise ValueError(
            f"{what} over a mesh of {len(devs)} devices ({list(devs)}) in "
            "one process: the port runs one process a position — build the "
            "mesh inside a torch.distributed world (launch/mesh.py; "
            "runtime/dist.py::launch)")
    return devs[0]


def plan_device(plan, what: str) -> Optional[torch.device]:
    """The device a plan's mesh computes on, or None without a plan or
    mesh."""
    mesh = getattr(plan, "mesh", None) if plan is not None else None
    return None if mesh is None else mesh_device(mesh, what)


def is_rank_plan(plan) -> bool:
    """Whether `plan` carries a rank mesh of several processes."""
    mesh = getattr(plan, "mesh", None) if plan is not None else None
    return mesh is not None and mesh.is_rank_mesh and mesh.size > 1


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
        """The sharding constraint: the identity. A rank holds its own
        batch rows, and gather on use leaves every other dimension whole
        (module docstring); a mesh one process cannot drive raises."""
        if self.mesh is not None:
            mesh_device(self.mesh, "a sharding constraint")
        return x

    def batch_group(self):
        """The rank group of the batch axes."""
        return self.mesh.group(self.batch_axes)

    def batch_index(self) -> Tuple[int, int]:
        """(this rank's row-major position on the batch axes, their
        size): which block of the global batch it holds."""
        g = self.batch_group()
        return g.index, g.size

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


def distribute(items, plan: "ShardingPlan", fn):
    """fn(block) -> one result an item, run for contiguous blocks of
    `items` (one a batch position of a rank plan, on that position's rank
    whose other coordinates are all 0), the results all-gathered as
    objects -> every rank's list in item order."""
    from .dist import all_gather_object
    mesh = plan.mesh
    g = plan.batch_group()
    blocks = np.array_split(np.arange(len(items)), g.size)
    others = [a for a in mesh.axis_names if a not in plan.batch_axes]
    lead = all(mesh.coords[a] == 0 for a in others)
    mine = list(blocks[g.index]) if lead else []
    out = fn([items[i] for i in mine]) if mine else []
    got = {}
    for idx, res in all_gather_object((mine, out), mesh.group(
            mesh.axis_names)):
        got.update(zip(idx, res))
    return [got[i] for i in range(len(items))]


def shard_compress(x: np.ndarray, plan: ShardingPlan,
                   eb_rel: float = 1e-4, chunk_values: int = 1 << 20,
                   block_size: int = 4096, device="cuda"):
    """Shard-parallel fused compression of one large array.

    Cuts `x` along its leading axis into one shard per position of the
    plan's batch axes (a single shard without a mesh) and compresses them
    through one pair of fused passes — each shard an independent CEAZ
    stream. Returns (compressed_list, shard_len), shard_len being the
    leading-axis extent of every shard but possibly the last; a ragged
    tail takes its own pass. On a rank mesh each batch position's rank
    compresses its shard on its device and every rank returns the whole
    list; on a logical mesh the passes run on the device it names, else
    on `device` (the card unless the caller asks for the CPU).
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
    if is_rank_plan(plan):
        comps = distribute(shards, plan,
                           lambda blk: [c for s in blk for c in run([s])])
    elif len({s.shape for s in shards}) > 1:    # ragged tail: pad-free split
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


def param_shardings(params, plan: ShardingPlan, shapes=None):
    """{path: NamedSharding or None} for a flat or nested tree (paths in
    ``convert.tree_items`` order). `shapes`: {path: whole shape} when the
    leaves are one rank's shards (a shard's shape does not tell whether
    the guard replicated a dimension)."""
    from ..convert import tree_items
    return {k: leaf_sharding(k, tuple(shapes[k]) if shapes is not None
                             else tuple(getattr(v, "shape", ())), plan)
            for k, v in tree_items(params)}


def _dim_axes(part):
    return () if part is None else (part if isinstance(part, tuple)
                                    else (part,))


def shard_slices(shape, sharding: NamedSharding, coords=None,
                 dims=None) -> Tuple[slice, ...]:
    """The block of a leaf of `shape` that the mesh position `coords`
    ({axis: coordinate}; default this rank's) holds: along each dimension
    its spec names, the block those coordinates select (row-major over
    the axes in the spec's order). `dims`: slice only these dimensions
    (the others whole)."""
    mesh = sharding.mesh
    coords = mesh.coords if coords is None else coords
    sizes = mesh.shape
    out = []
    for i, n in enumerate(shape):
        axes = _dim_axes(sharding.spec[i] if i < len(sharding.spec)
                         and (dims is None or i in dims) else None)
        idx, tot = 0, 1
        for a in axes:
            idx, tot = idx * sizes[a] + coords[a], tot * sizes[a]
        if n % tot:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"divide over {axes} ({tot})")
        step = n // tot
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def place(arr, sharding: Optional[NamedSharding]):
    """A host leaf (numpy array or tensor) placed by its sharding: on a
    rank mesh, this rank's shard (:func:`shard_slices`) as a tensor of its
    own on the rank's device; on a logical mesh, the whole leaf on the
    device it names. With no sharding, the leaf unchanged."""
    from .fused import target_device
    if sharding is None:
        return arr
    dev = target_device(mesh_device(sharding.mesh, "placement"))
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.asarray(arr, order="C"))
    arr = torch.as_tensor(arr)
    if sharding.mesh.is_rank_mesh:       # a copy: the whole leaf can go
        return arr[shard_slices(arr.shape, sharding)].to(
            dev, copy=True, memory_format=torch.contiguous_format)
    return arr.to(dev)


def gather_leaf(t: torch.Tensor, sharding: Optional[NamedSharding],
                dims=None):
    """The inverse of :func:`place`: a rank's shard all-gathered over the
    axes of its spec, dimension by dimension (the innermost axis of a
    dimension first, so a dimension split over (data, model) comes back
    in the spec's row-major order), to the whole leaf on the rank's
    device. `dims`: gather only these dimensions (the others stay the
    rank's block). Without a sharding or a rank mesh, `t` unchanged."""
    from .dist import gather_cat
    if sharding is None or not sharding.mesh.is_rank_mesh:
        return t
    mesh = sharding.mesh
    for i, part in enumerate(sharding.spec):
        if dims is not None and i not in dims:
            continue
        for a in reversed(_dim_axes(part)):
            t = gather_cat(t.contiguous(), mesh.group(a), i)
    return t


def place_cache(cache, shardings):
    """A decode cache (whole leaves, host or device) placed by the tree of
    NamedShardings ``launch/serve.py::cache_shardings`` gives for it: on
    a rank mesh every leaf the rank's slice (:func:`place`), a
    ``decode_wide`` sequence cut over the batch axes and model at once."""
    from ..convert import map_tree, tree_items
    shd = dict(tree_items(shardings))
    return map_tree(lambda k, v: place(v, shd[k]), cache)


def gather_cache(cache, shardings):
    """The inverse of :func:`place_cache`: every leaf of a rank's cache
    slices gathered whole (:func:`gather_leaf`)."""
    from ..convert import map_tree, tree_items
    shd = dict(tree_items(shardings))
    return map_tree(lambda k, v: gather_leaf(v, shd[k]), cache)
