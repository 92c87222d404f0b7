"""The bitpack ops: fixed-width b-bit pack/unpack, MSB-first into u32
words, b in {2, 4, 8, 16} (per = 32/b values a word).

Two layouts, each a pair of ops:

  * the tile layout of the reference's TPU kernel
    (``src/repro/kernels/bitpack/{kernel,ops}.py``):
      pack(vals (R, per, 128) int32, bits) -> words (R, 128)
      unpack(words (R, 128), bits) -> vals (R, per, 128) int32
    word (r, l) holds v[r, k, l]; R % 8 == 0. ``pack_flat`` /
    ``unpack_flat`` zero-pad a flat array to that layout
    (:func:`packed_rows` rows) and trim it back;
  * the consecutive layout of the fixed-width wire path (the reference's
    ``optim/grad_compress.py::pack_jnp`` / ``unpack_jnp``):
      pack_words(q (n,) int32, bits) -> words (ceil(n/per),)
      unpack_words(words, n, bits) -> q (n,) int32
    word i holds q[i*per .. i*per+per-1], the tail word zero-padded.

Words are int32 tensors holding the u32 bits (``.numpy().view(np.uint32)``
gives the reference's words). Each value is masked to b bits before it is
placed, as the TPU kernel does (``pack_jnp`` does not mask; its inputs
are in range, where the two agree).

  * ``*_plain`` — plain PyTorch (any device); words ride in int64 because
    CPU ``torch.uint32`` has no shifts. The CPU tests and chip_smoke.py
    hold the kernels against these;
  * ``*_cuda``  — csrc/bitpack.cu, one thread per word; every call counts
    one launch of ``pack`` or ``unpack``.

The un-suffixed functions resolve through the dispatch registry by the
tensor's device (``impl='auto'``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .. import dispatch

LANES = 128
SUBLANES = 8
BITS = (2, 4, 8, 16)
_M32 = 0xFFFFFFFF
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_ARGS = [_P, _I64, _I64, _I32, _I32, _P, _P]


def _per(bits: int) -> int:
    if bits not in BITS:
        raise ValueError(f"bits must be one of {BITS}, got {bits}")
    return 32 // bits


def _layout(n: int, bits: int) -> Tuple[int, int]:
    """(rows, per) of the tile layout holding n values: at least one row,
    rows rounded up to a multiple of 8 (the reference's ``_layout``)."""
    per = _per(bits)
    rows = max(-(-n // (per * LANES)), 1)
    return -(-rows // SUBLANES) * SUBLANES, per


def packed_rows(n: int, bits: int) -> int:
    return _layout(n, bits)[0]


def words_len(n: int, bits: int) -> int:
    """Words of the consecutive layout: ceil(n*bits/32)."""
    return -(-n // _per(bits))


def _check_vals(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: int32 values expected, got {t.dtype}")


def _check_tile(name: str, shape, per: int, vals: bool) -> None:
    want = f"(R, {per}, {LANES})" if vals else f"(R, {LANES})"
    ok = (len(shape) == (3 if vals else 2) and shape[-1] == LANES
          and shape[0] % SUBLANES == 0 and (not vals or shape[1] == per))
    if not ok:
        raise ValueError(f"{name}: {want} with R % {SUBLANES} == 0 expected, "
                         f"got {tuple(shape)}")


# -- plain PyTorch -------------------------------------------------------------

def _shifts(per: int, bits: int, device) -> torch.Tensor:
    return 32 - bits * (torch.arange(per, dtype=torch.int64, device=device)
                        + 1)


def _pack_groups(v: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """OR the per values along `dim` (int32, any range) into int32 words:
    the fields are disjoint after the mask, so the sum is the OR."""
    per = 32 // bits
    sh = _shifts(per, bits, v.device).reshape(
        [per if d == dim % v.ndim else 1 for d in range(v.ndim)])
    v = v.to(torch.int64) & ((1 << bits) - 1)
    return (v << sh).sum(dim).to(torch.int32)


def _unpack_groups(words: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """The inverse: a new axis of per values at `dim`, int32."""
    per = 32 // bits
    w = words.to(torch.int64).unsqueeze(dim) & _M32
    sh = _shifts(per, bits, words.device).reshape(
        [per if d == dim % w.ndim else 1 for d in range(w.ndim)])
    return ((w >> sh) & ((1 << bits) - 1)).to(torch.int32)


def pack_plain(vals: torch.Tensor, bits: int) -> torch.Tensor:
    per = _per(bits)
    _check_vals("pack", vals)
    _check_tile("pack", vals.shape, per, vals=True)
    return _pack_groups(vals, bits, 1)


def unpack_plain(words: torch.Tensor, bits: int) -> torch.Tensor:
    per = _per(bits)
    _check_tile("unpack", words.shape, per, vals=False)
    return _unpack_groups(words, bits, 1)


def pack_flat_plain(x: torch.Tensor, bits: int) -> torch.Tensor:
    flat = x.reshape(-1)
    _check_vals("pack_flat", flat)
    rows, per = _layout(flat.numel(), bits)
    padded = torch.nn.functional.pad(flat, (0, rows * per * LANES
                                            - flat.numel()))
    return pack_plain(padded.reshape(rows, per, LANES), bits)


def unpack_flat_plain(words: torch.Tensor, n: int,
                      bits: int) -> torch.Tensor:
    _check_room("unpack_flat", words.numel(), n, bits)
    return unpack_plain(words, bits).reshape(-1)[:n]


def pack_words_plain(q: torch.Tensor, bits: int) -> torch.Tensor:
    per = _per(bits)
    _check_vals("pack_words", q)
    n = q.numel()
    padded = torch.nn.functional.pad(q.reshape(-1), (0, (-n) % per))
    return _pack_groups(padded.reshape(-1, per), bits, 1)


def _check_room(name: str, n_words: int, n: int, bits: int) -> None:
    if n > n_words * _per(bits):
        raise ValueError(f"{name}: {n_words} words hold at most "
                         f"{n_words * _per(bits)} values, not {n}")


def unpack_words_plain(words: torch.Tensor, n: int,
                       bits: int) -> torch.Tensor:
    _check_room("unpack_words", words.numel(), n, bits)
    return _unpack_groups(words.reshape(-1), bits, 1).reshape(-1)[:n]


# -- CUDA ----------------------------------------------------------------------

def _pack_launch(vals: torch.Tensor, n_words: int, bits: int,
                 tile: bool) -> torch.Tensor:
    dispatch.require_cuda("pack", vals)
    _check_vals("pack", vals)
    words = torch.empty(n_words, dtype=torch.int32, device=vals.device)
    dispatch.count_launch("pack")
    rc = _build.function("ceaz_bitpack_pack", _ARGS)(
        vals.data_ptr(), vals.numel(), n_words, bits, int(tile),
        words.data_ptr(), dispatch.stream_handle())
    _build.check(rc, "pack")
    return words


def _unpack_launch(words: torch.Tensor, n: int, bits: int,
                   tile: bool) -> torch.Tensor:
    dispatch.require_cuda("unpack", words)
    if words.dtype != torch.int32:
        raise ValueError(f"unpack: int32 words expected, got {words.dtype}")
    vals = torch.empty(n, dtype=torch.int32, device=words.device)
    dispatch.count_launch("unpack")
    rc = _build.function("ceaz_bitpack_unpack", _ARGS)(
        words.data_ptr(), words.numel(), n, bits, int(tile),
        vals.data_ptr(), dispatch.stream_handle())
    _build.check(rc, "unpack")
    return vals


def pack_cuda(vals: torch.Tensor, bits: int) -> torch.Tensor:
    per = _per(bits)
    _check_tile("pack", vals.shape, per, vals=True)
    return _pack_launch(vals, vals.shape[0] * LANES, bits,
                        True).reshape(-1, LANES)


def unpack_cuda(words: torch.Tensor, bits: int) -> torch.Tensor:
    per = _per(bits)
    _check_tile("unpack", words.shape, per, vals=False)
    return _unpack_launch(words, words.numel() * per, bits,
                          True).reshape(-1, per, LANES)


def pack_flat_cuda(x: torch.Tensor, bits: int) -> torch.Tensor:
    rows, _ = _layout(x.numel(), bits)
    return _pack_launch(x.reshape(-1), rows * LANES, bits,
                        True).reshape(rows, LANES)


def unpack_flat_cuda(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    per = _per(bits)
    _check_tile("unpack_flat", words.shape, per, vals=False)
    _check_room("unpack_flat", words.numel(), n, bits)
    return _unpack_launch(words, n, bits, True)


def pack_words_cuda(q: torch.Tensor, bits: int) -> torch.Tensor:
    return _pack_launch(q.reshape(-1), words_len(q.numel(), bits), bits,
                        False)


def unpack_words_cuda(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    _check_room("unpack_words", words.numel(), n, bits)
    return _unpack_launch(words.reshape(-1), n, bits, False)


# -- by device -----------------------------------------------------------------

def pack(vals: torch.Tensor, bits: int, impl: str = "auto") -> torch.Tensor:
    return dispatch.resolve("pack", impl, vals.device)(vals, bits)


def unpack(words: torch.Tensor, bits: int, impl: str = "auto") -> torch.Tensor:
    return dispatch.resolve("unpack", impl, words.device)(words, bits)


def pack_flat(x: torch.Tensor, bits: int, impl: str = "auto") -> torch.Tensor:
    return dispatch.resolve("pack_flat", impl, x.device)(x, bits)


def unpack_flat(words: torch.Tensor, n: int, bits: int,
                impl: str = "auto") -> torch.Tensor:
    return dispatch.resolve("unpack_flat", impl, words.device)(words, n, bits)


def pack_words(q: torch.Tensor, bits: int, impl: str = "auto") -> torch.Tensor:
    return dispatch.resolve("pack_words", impl, q.device)(q, bits)


def unpack_words(words: torch.Tensor, n: int, bits: int,
                 impl: str = "auto") -> torch.Tensor:
    return dispatch.resolve("unpack_words", impl, words.device)(
        words, n, bits)
