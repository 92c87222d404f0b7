"""Carry codec state between the JAX reference and the port.

The system has no model weights: its state is the codebooks and the
compressed records. These move between the two packages through their
numpy fields, read by duck typing, so this module imports nothing of
the reference:

    port_c = from_reference(ref_c)               # ref record -> port
    fields = to_reference_fields(port_c)         # port record -> kwargs
    ref_c = ref_ceaz.CEAZCompressed(**{**fields, "chunks": [
        ref_ceaz.CompressedChunk(**f) for f in fields["chunks"]]})

Parameter-like trees (params, gradients, the error-feedback residual,
the AdamW moments) are nested dicts/lists of numpy arrays in the
reference and flat ``dict[str, Tensor]`` in the port, keyed by the paths
``repro.runtime.compat.keystr`` gives, in ``jax.tree.leaves`` order:

    params = tree_from_reference(ref_params)            # on the card
    opt = opt_state_from_reference(ref_opt, device="cpu")
    ref_params = tree_to_reference(params, like=ref_params)

Model parameter trees keep the reference's nesting (dicts and lists,
each unit's leaves stacked on a repeat axis), with tensors at the
leaves: ``map_tree`` over the reference tree puts the flat dict's
tensors back in it, and ``tree_to_reference`` takes either form back.

bf16 leaves (numpy's ``bfloat16`` from ml_dtypes) cross as their uint16
bits, so the port never imports ml_dtypes.

Codebooks convert the same way (``lengths``, ``codes``, ``max_len``);
their ``id`` is a hash of the lengths, so it survives the trip. A
record's bank fields (``center``, ``bank_ref``, ``bank_index``) travel
with the other chunk fields; the bank itself converts with
:func:`bank_from_reference` and keeps its content-hash id, so a
converted bank resolves the ``bank_ref`` of reference records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .core.ceaz import CEAZCompressed, CompressedChunk
from .core.codebook import CodebookBank
from .core.huffman import Codebook


def _copy(v):
    return np.array(v, copy=True) if isinstance(v, np.ndarray) else v


def _fields(obj, cls) -> Dict[str, Any]:
    """The dataclass fields of `cls` read off `obj` (missing optional
    fields take their defaults, as old pickles do in the reference)."""
    out = {}
    for f in dataclasses.fields(cls):
        if hasattr(obj, f.name):
            out[f.name] = _copy(getattr(obj, f.name))
    return out


def from_reference(obj):
    """A reference Codebook, CompressedChunk or CEAZCompressed as the
    port's own class (recognised by its attributes)."""
    if hasattr(obj, "chunks"):
        f = _fields(obj, CEAZCompressed)
        f["shape"] = tuple(int(s) for s in f["shape"])
        f["chunks"] = [from_reference(ch) for ch in obj.chunks]
        return CEAZCompressed(**f)
    if hasattr(obj, "block_nbits"):
        return CompressedChunk(**_fields(obj, CompressedChunk))
    if hasattr(obj, "lengths") and hasattr(obj, "codes"):
        return Codebook(lengths=np.array(obj.lengths, np.uint8),
                        codes=np.array(obj.codes, np.uint32),
                        max_len=int(obj.max_len))
    raise TypeError(f"cannot convert {type(obj).__name__}: not a codebook "
                    "or compressed record")


def to_reference_fields(obj) -> Dict[str, Any]:
    """The constructor fields of a port record for the reference's class
    of the same name (a CEAZCompressed's ``chunks`` as a list of chunk
    field dicts)."""
    if isinstance(obj, CEAZCompressed):
        f = _fields(obj, CEAZCompressed)
        f["chunks"] = [to_reference_fields(ch) for ch in obj.chunks]
        return f
    if isinstance(obj, CompressedChunk):
        return _fields(obj, CompressedChunk)
    if isinstance(obj, Codebook):
        return dict(lengths=obj.lengths.copy(), codes=obj.codes.copy(),
                    max_len=obj.max_len)
    raise TypeError(f"cannot convert {type(obj).__name__}: not a port "
                    "codebook or compressed record")


def bank_from_reference(bank) -> CodebookBank:
    """A reference CodebookBank as the port's (its ``lengths``,
    ``version`` and ``meta`` read as plain values); the id, a hash of
    version and lengths, is the same on both sides."""
    return CodebookBank(lengths=np.array(bank.lengths, np.uint8),
                        version=int(bank.version), meta=dict(bank.meta))


# -- parameter-like trees --------------------------------------------------------

def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs of a nested dict/list/tuple tree in the order of
    ``jax.tree.leaves`` (dict keys sorted), keys joined by '/' as
    ``keystr(path, simple=True, separator='/')`` joins them. None is an
    empty subtree, as in JAX."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


_TENSOR_ONLY = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def host_leaf(leaf):
    """A leaf on the host, as the stream engine writes it: a numpy array,
    or a CPU tensor for the dtypes numpy cannot hold (bfloat16, float8).
    A tensor is copied, so later in-place writes do not reach it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        return t if t.dtype in _TENSOR_ONLY else t.numpy()
    return np.asarray(leaf)


def dtype_name(leaf) -> str:
    """numpy's name for a leaf's dtype ('float32', 'bfloat16')."""
    dt = leaf.dtype
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else str(dt)


def _is_bf16(dtype) -> bool:
    return np.dtype(dtype).name == "bfloat16"


def _to_tensor(leaf, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(leaf))
    if _is_bf16(arr.dtype):
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def _to_numpy(t: torch.Tensor, dtype) -> np.ndarray:
    t = t.detach().cpu()
    if _is_bf16(dtype):
        return t.to(torch.bfloat16).view(torch.int16).numpy().view(dtype)
    return t.numpy().astype(dtype, copy=False)


def map_tree(fn, tree, prefix: str = ""):
    """`tree` with the same dicts, lists and tuples and fn(path, leaf) at
    the leaves, path the key ``tree_items`` gives the leaf (None stays an
    empty subtree)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix[:-1], tree)


def tree_from_reference(tree, device="cuda") -> Dict[str, torch.Tensor]:
    """A reference pytree of arrays -> {keystr path: Tensor} on `device`
    (the card unless device='cpu')."""
    from .runtime.fused import target_device
    dev = target_device(device)
    return {k: _to_tensor(v, dev) for k, v in tree_items(tree)}


def tree_to_reference(tree, like):
    """{keystr path: Tensor}, or a nested tree of tensors -> a tree shaped
    as `like` (the reference tree it came from) with numpy leaves of
    like's dtypes."""
    flat = dict(tree_items(tree))

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(node[k], f"{prefix}{k}/") for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        if node is None:
            return None
        return _to_numpy(flat[prefix[:-1]], np.asarray(node).dtype)
    return build(like, "")


def opt_state_from_reference(state, device="cuda") -> Dict[str, Any]:
    """The reference's AdamW state {"mu", "nu", "step"} -> the port's."""
    from .runtime.fused import target_device
    dev = target_device(device)
    return {"mu": tree_from_reference(state["mu"], dev),
            "nu": tree_from_reference(state["nu"], dev),
            "step": _to_tensor(state["step"], dev)}


def opt_state_to_reference(state: Dict[str, Any], like) -> Dict[str, Any]:
    return {"mu": tree_to_reference(state["mu"], like["mu"]),
            "nu": tree_to_reference(state["nu"], like["nu"]),
            "step": _to_numpy(state["step"], np.asarray(like["step"]).dtype)}
