"""Carry codec state between the JAX reference and the port.

The system has no model weights: its state is the codebooks and the
compressed records. These move between the two packages through their
numpy fields, read by duck typing, so this module imports nothing of
the reference:

    port_c = from_reference(ref_c)               # ref record -> port
    fields = to_reference_fields(port_c)         # port record -> kwargs
    ref_c = ref_ceaz.CEAZCompressed(**{**fields, "chunks": [
        ref_ceaz.CompressedChunk(**f) for f in fields["chunks"]]})

Codebooks convert the same way (``lengths``, ``codes``, ``max_len``);
their ``id`` is a hash of the lengths, so it survives the trip. A
record's bank fields (``center``, ``bank_ref``, ``bank_index``) travel
with the other chunk fields; the bank itself converts with
:func:`bank_from_reference` and keeps its content-hash id, so a
converted bank resolves the ``bank_ref`` of reference records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

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
