"""Fixed-width compressed gradient exchange over the pod axis.

The reference (``src/repro/optim/grad_compress.py``) runs this inside a
``shard_map`` over the 'pod' mesh axis of the training step. Per leaf:

  1. error feedback: g += residual (kept in the optimizer state);
  2. scale = max|g| / (2^(bits-1) - 1) + 1e-30, codes = clip(rint(g /
     scale)) + half: the fixed-ratio mode's per-leaf bound;
  3. pack the codes at ``bits`` wide (the bitpack op, consecutive layout;
     csrc/bitpack.cu on the card);
  4. all-gather the packed words and the scale over the pods, unpack,
     dequantize, mean over pods;
  5. new residual = g - dequant(quant(g)).

Here the pod axis is a ``torch.distributed`` group, or the leading axis
of every leaf:

  * ``group=None``: each gradient and residual leaf is (P, *shape), pod p
    in row p. The pods are packed and unpacked together (one launch of
    each a leaf) and the mean is taken over the rows. This is the form one
    card runs.
  * a group (a ``runtime/dist.py::RankGroup`` of a rank mesh, or a
    ``torch.distributed`` group): each process holds its own pod's
    (*shape) leaves and all-gathers its words and scale, as the
    reference's ``all_gather`` (``launch/train.py`` runs it inside the
    train step over the pod axis of a rank mesh).

Both give the bits of the reference: the words, scales, residuals and
the pod mean (summed in pod order from 0.0, then divided by P, as XLA
reduces axis 0 on the CPU).

Trees are ``dict[str, Tensor]`` keyed by the reference's ``keystr`` paths
in its ``jax.tree.leaves`` order (``convert.tree_from_reference``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..kernels.bitpack import ops as BP
from ..runtime.fused import target_device

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """The reference's config less ``axis``: the pod axis is the
    ``group`` argument (or the leaves' leading axis). ``enabled`` is read
    by the train step (``launch/train.py``): with a pod axis it asks for
    the compressed exchange."""
    bits: int = 8                  # code width (2|4|8|16)
    enabled: bool = True
    error_feedback: bool = True    # False: the residual passes unchanged


def ef_init(params: Tree, device="cuda") -> Tree:
    """Error-feedback residual state: f32 zeros shaped as the params."""
    dev = target_device(device)
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
            for k, p in params.items()}


def _half(bits: int) -> int:
    return (1 << (bits - 1)) - 1


_TINY = float(np.float32(1e-30))


# fma_f32 works in blocks of this many values along the last dimension:
# its float64 temporaries of a whole 3e8-value leaf would take ~15 GB
_FMA_BLOCK = 1 << 24


def fma_f32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a * b + c for f32 operands, rounded to f32 once: the FMA that XLA
    on the CPU contracts a multiply and an add into. The product of two
    f32 values is exact in float64; TwoSum gives the float64 sum s and its
    exact remainder e; s rounds to f32 as the exact sum does unless s lies
    on an f32 midpoint, where e (if not 0) decides the side. Elementwise,
    so a large operand is taken in blocks of its last dimension (the same
    bits, bounded temporaries)."""
    c = torch.as_tensor(c, dtype=torch.float32, device=a.device)
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape)
    n = shape[-1] if shape else 1
    if n <= _FMA_BLOCK:
        return _fma_f32(a, b, c)
    a, b, c = (t.expand(shape) for t in (a, b, c))
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    for i in range(0, n, _FMA_BLOCK):
        j = min(n, i + _FMA_BLOCK)
        out[..., i:j] = _fma_f32(a[..., i:j], b[..., i:j], c[..., i:j])
    return out


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    p = a.to(torch.float64) * b.to(torch.float64)
    c = torch.as_tensor(c, dtype=torch.float32, device=p.device).to(
        torch.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    f = s.to(torch.float32)
    fb = f.to(torch.float64)
    inf = torch.full_like(f, float("inf"))
    nb = torch.nextafter(f, torch.where(s > fb, inf, -inf))  # toward s
    tie = (s != fb) & (s == (fb + nb.to(torch.float64)) / 2)
    past = tie & (e != 0) & ((e > 0) == (s > fb))
    return torch.where(past, nb, f)


def row_scales(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """max|g| / half + 1e-30 (f32) as the reference's compiled XLA takes
    it on the CPU: the divide by the constant becomes a multiply by its
    f32 reciprocal, contracted with the add into one FMA."""
    recip = torch.tensor(1.0, dtype=torch.float32) / _half(bits)
    return fma_f32(amax, recip.to(amax.device), _TINY)


def quantize_rows(g2: torch.Tensor, bits: int):
    """g2 (P, n) f32 -> (codes (P, n) int32 in [0, 2^bits), scales (P,) f32),
    one scale a row (:func:`row_scales`). NaN codes as 0 (XLA's
    float->int32 cast), so a row holding NaN or Inf (scale NaN or Inf)
    decodes to NaN throughout."""
    half = _half(bits)
    scale = row_scales(g2.abs().amax(dim=1), bits)
    q = torch.round(g2 / scale[:, None]).clamp_(-half, half)
    q = torch.where(torch.isnan(q), 0.0, q)
    return q.to(torch.int32) + half, scale


def _centered(codes2: torch.Tensor, bits: int) -> torch.Tensor:
    return codes2.to(torch.float32) - _half(bits)


def dequantize_rows(codes2: torch.Tensor, scales: torch.Tensor,
                    bits: int) -> torch.Tensor:
    return _centered(codes2, bits) * scales[:, None]


def _quantize_leaf(g: torch.Tensor, bits: int):
    """g (f32) -> (codes int32 in [0, 2^bits), scale f32 0-dim tensor)."""
    codes, scale = quantize_rows(g.reshape(1, -1), bits)
    return codes.reshape(g.shape), scale[0]


def _dequantize_leaf(codes: torch.Tensor, scale: torch.Tensor, bits: int):
    return dequantize_rows(codes.reshape(1, -1), scale.reshape(1),
                           bits).reshape(codes.shape)


def compress_decompress_leaf(g: torch.Tensor, bits: int):
    """Local quantize -> pack -> unpack -> dequantize round trip (what the
    remote pods reconstruct) -> (rec, packed words, scale)."""
    q, scale = _quantize_leaf(g, bits)
    packed = BP.pack_words(q.reshape(-1), bits)
    rec = _dequantize_leaf(BP.unpack_words(packed, g.numel(), bits), scale,
                           bits)
    return rec.reshape(g.shape), packed, scale


def gather_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """(world, *t.shape): every process's t in rank order. `group`: a
    ``runtime/dist.py::RankGroup`` (its exchange staged through the host,
    so CUDA tensors cross a gloo group) or a ``torch.distributed`` group."""
    from ..runtime.dist import RankGroup, all_gather
    if isinstance(group, RankGroup):
        return torch.stack(all_gather(t.contiguous(), group))
    import torch.distributed as dist
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def _group_rank(group) -> int:
    from ..runtime.dist import RankGroup
    if isinstance(group, RankGroup):
        return group.index
    import torch.distributed as dist
    return dist.get_rank(group)


def pod_mean(q2: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Mean over the pods of q2 (P, n) centred codes times their scales,
    as XLA evaluates the reference's ``vals.mean(0)``: one FMA a pod into
    an f32 sum from 0, in pod order, then times f32(1/P)."""
    acc = torch.zeros_like(q2[0])
    for q, s in zip(q2, scales):
        acc = fma_f32(q, s, acc)
    recip = torch.tensor(1.0, dtype=torch.float32) / q2.shape[0]
    return acc * recip.to(acc.device)


def _leaf(g: torch.Tensor, r: torch.Tensor, cfg: CompressionConfig, group):
    bits, per = cfg.bits, 32 // cfg.bits
    pods = 1 if group is not None else g.shape[0]
    shape = g.shape[1:] if group is None else g.shape
    n = int(np.prod(shape, dtype=np.int64))
    npad = -(-n // per) * per
    g32 = g.to(torch.float32).reshape(pods, n)
    if cfg.error_feedback:
        g32 = g32 + r.reshape(pods, n)
    flat = torch.nn.functional.pad(g32, (0, npad - n))
    codes, scale = quantize_rows(flat, bits)
    packed = BP.pack_words(codes, bits)             # (pods * npad / per,)
    if group is not None:
        packed = gather_ranks(packed, group).reshape(-1)
        scale = gather_ranks(scale, group).reshape(-1)
    q2 = _centered(BP.unpack_words(packed, packed.numel() * per, bits)
                   .reshape(-1, npad), bits)
    mean = pod_mean(q2, scale)[:n].reshape(shape).to(g.dtype)
    if not cfg.error_feedback:
        return mean, r
    if group is not None:       # this pod's row alone stays alive
        rank = _group_rank(group)
        q2, scale = q2[rank:rank + 1].clone(), scale[rank:rank + 1]
    # flat - dequant: XLA contracts the product into the subtraction
    new_r = fma_f32(-q2, scale[:, None], flat)[:, :n].reshape(g.shape)
    return mean, new_r


def compressed_cross_pod_mean(grads: Tree, residual: Tree,
                              cfg: CompressionConfig, group=None,
                              device="cuda") -> Tuple[Tree, Tree]:
    """Per-pod grads -> (pod-mean grads, new residual).

    With ``group=None`` every leaf is (P, *shape), pods on the leading axis,
    and the mean leaves are (*shape); with a group every leaf is this
    process's (*shape). The work runs on ``device`` (the card unless
    ``device='cpu'``; a gloo group takes CPU tensors)."""
    dev = target_device(device)
    mean, new_res = {}, {}
    for k, g in grads.items():
        mean[k], new_res[k] = _leaf(g.to(dev), residual[k].to(dev), cfg,
                                    group)
    return mean, new_res


def payload_fraction(bits: int) -> float:
    """Wire bytes vs uncompressed bf16 exchange."""
    return bits / 16.0


# ---------------------------------------------------------------------------
# Gradient snapshots through the fused CEAZ pipeline (the offload path).
# ---------------------------------------------------------------------------

def _grad_compressor(eb_rel: float, chunk_bytes: int, device):
    from ..core import CEAZ, CEAZConfig
    return CEAZ(CEAZConfig(mode="rel", eb=eb_rel, chunk_bytes=chunk_bytes,
                           predictor="auto", use_fused=True, device=device))


def _compressible(arr: np.ndarray, min_compress: int) -> bool:
    return bool(arr.dtype == np.float32 and arr.size >= min_compress
                and np.all(np.isfinite(arr)))


def snapshot_grads(grads, eb_rel: float = 1e-3, chunk_bytes: int = 1 << 22,
                   min_compress: int = 4096, device="cuda"):
    """-> {path: CEAZCompressed | np.ndarray} for a gradient tree (the
    port's flat dict or a nested one; paths in ``tree_items`` order).

    Float32 leaves of at least min_compress finite values are compressed
    by the port's facade (fused, rel bound, ``predictor='auto'``: noise-
    like leaves go value-direct, smooth ones Lorenzo); others are kept
    raw."""
    from ..convert import host_leaf, tree_items
    comp = _grad_compressor(eb_rel, chunk_bytes, device)
    out = {}
    for key, leaf in tree_items(grads):
        arr = host_leaf(leaf)
        out[key] = (comp.compress(arr)
                    if _compressible(arr, min_compress) else arr)
    return out


def restore_grad_snapshot(snapshot, device="cuda"):
    """Inverse of snapshot_grads: {path: np.ndarray}. Every compressed leaf
    decodes in one batched pass of the facade."""
    from ..core import CEAZ, CEAZCompressed, CEAZConfig
    comp = CEAZ(CEAZConfig(use_fused=True, device=device))
    keys = [k for k, v in snapshot.items() if isinstance(v, CEAZCompressed)]
    dec = dict(zip(keys, comp.decompress_batch([snapshot[k]
                                                for k in keys])))
    return {k: dec.get(k, v) for k, v in snapshot.items()}


def snapshot_grads_to_stream(path: str, grads, eb_rel: float = 1e-3,
                             chunk_bytes: int = 1 << 22,
                             min_compress: int = 4096,
                             overlap: bool = True, device="cuda"):
    """Stream a gradient snapshot to disk through the async engine: the
    facade on `device` compresses leaf i+1 while the committer appends
    leaf i to one indexed ``.ceazs`` stream (records keyed by
    ``tree_items`` paths; leaves copied to the host by
    ``convert.host_leaf``).
    Which leaves compress is :func:`snapshot_grads`'s rule. Returns the
    engine stats dict (raw/stored bytes, overlap efficiency)."""
    from ..convert import dtype_name, host_leaf, tree_items
    from ..io import engine as E
    comp = _grad_compressor(eb_rel, chunk_bytes, device)

    def encode(keys, items):
        return [comp.compress(a) if _compressible(a, min_compress) else a
                for a in items]

    eng = E.AsyncCompressWriteEngine(
        path, encode, sync=not overlap,
        meta={"kind": "grad_snapshot", "eb_rel": eb_rel},
        block_size=comp.cfg.block_size)
    with eng:
        for key, leaf in tree_items(grads):
            arr = host_leaf(leaf)
            eng.submit(key, arr, meta={"shape": list(arr.shape),
                                       "dtype": dtype_name(arr),
                                       "raw_nbytes": int(arr.nbytes)})
    return eng.stats.as_dict()


def restore_grad_snapshot_stream(path: str, group: int = 8, device="cuda"):
    """Read a streamed snapshot back as {path: np.ndarray}, the stream's
    index and checksums validated: the engine's prefetch thread reads
    leaf i+1 while a group of `group` leaves decodes as one batched pass
    of the facade on `device`."""
    from ..core import CEAZ, CEAZConfig
    from ..io import engine as E
    comp = CEAZ(CEAZConfig(use_fused=True, device=device))
    with E.AsyncDecodeReadEngine(path, comp, group=group) as eng:
        return {rec["key"]: obj for rec, obj in eng}
