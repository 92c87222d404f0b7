"""The `dualquant` op: pass 1's dual-quantization of a whole work field.

Two implementations, one contract (see kernels/dispatch.py):

  * :func:`dual_quantize_plain` — the torch twin (core/dualquant.py);
  * :func:`dual_quantize_cuda`  — the hand kernels of csrc/dualquant.cu:
    ``dq1d`` for rank-1 work (global 1-D Lorenzo), ``dq2d`` for rank-2
    (global 2-D Lorenzo). Rank-3 work has no kernel — the reference has
    no Pallas kernel for it either and runs jnp — so it takes the torch
    twin on the card.

Outputs: codes (int32), outlier flags (bool) and delta (int32) flat and
zero-padded to `n_out` (the chunked pass-1 layout), plus q, the flat
prequantized field (int32).

The `dq_center` op (value-direct centring) lives here too:

    dq_center(q2, valid2) -> centers (C,) int32

the count-aware median of each row's valid entries, ``lo + (hi-lo)//2``
of the two middle order statistics in int32 with wrap, 0 for a row with
no valid entry (the reference's ``dualquant/ops.py::chunk_center``).

  * :func:`chunk_center_plain` — the sort-based plain version;
  * :func:`dq_center_cuda`     — the range pass and wide-digit select
    of csrc/center.cu, for rows of any length and any row count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...core import dualquant as core_dq
from .. import _build
from .. import dispatch

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_DQ1D_ARGS = [_P, _I64, _I64, ctypes.c_float, _P, _P, _P, _P, _P]
_DQ2D_ARGS = [_P, _I64, _I64, _I64, ctypes.c_float, _P, _P, _P, _P, _P]
_CENTER_ARGS = [_P, _P, _I64, _I64, _P, _P, _P]
_INT32_MAX = 2**31 - 1


def _pad(a: torch.Tensor, n_out: int) -> torch.Tensor:
    flat = a.reshape(-1)
    return torch.nn.functional.pad(flat, (0, n_out - flat.numel()))


def dual_quantize_plain(work: torch.Tensor, eb: float, ndim: int,
                        n_out: int):
    """Plain PyTorch version (any device)."""
    codes, outl, delta, q = core_dq.dual_quantize(work, eb, ndim)
    return (_pad(codes, n_out), _pad(outl, n_out), _pad(delta, n_out),
            q.reshape(-1))


def dual_quantize_cuda(work: torch.Tensor, eb: float, ndim: int,
                       n_out: int):
    """The dq1d/dq2d kernels (rank 3: the torch twin on the card)."""
    dispatch.require_cuda("dualquant", work)
    if work.dtype != torch.float32:
        raise ValueError(f"dualquant: work must be float32, got {work.dtype}")
    if work.ndim != ndim or ndim not in (1, 2, 3):
        raise ValueError(f"dualquant: rank {work.ndim} work for ndim {ndim}")
    if ndim == 3:
        return dual_quantize_plain(work, eb, ndim, n_out)
    n = work.numel()
    dev = work.device
    codes = torch.empty(n_out, dtype=torch.int32, device=dev)
    outl = torch.empty(n_out, dtype=torch.bool, device=dev)
    delta = torch.empty(n_out, dtype=torch.int32, device=dev)
    q = torch.empty(n, dtype=torch.int32, device=dev)
    outs = (codes.data_ptr(), outl.data_ptr(), delta.data_ptr(), q.data_ptr(),
            dispatch.stream_handle())
    if ndim == 1:
        fn = _build.function("ceaz_dq1d", _DQ1D_ARGS)
        dispatch.count_launch("dq1d")
        rc = fn(work.data_ptr(), n, n_out, float(eb), *outs)
        _build.check(rc, "dq1d")
    else:
        rows, cols = work.shape
        fn = _build.function("ceaz_dq2d", _DQ2D_ARGS)
        dispatch.count_launch("dq2d")
        rc = fn(work.data_ptr(), rows, cols, n_out, float(eb), *outs)
        _build.check(rc, "dq2d")
    return codes, outl, delta, q


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same residue mod 2^32."""
    return v.to(torch.int32)


def chunk_center_plain(q2: torch.Tensor, valid2: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch version (any device): sort each row with invalid
    entries sent to the top, index the two middle order statistics of
    the valid prefix."""
    C, V = q2.shape
    if V == 0:
        return torch.zeros(C, dtype=torch.int32, device=q2.device)
    qm = torch.where(valid2, q2.to(torch.int32),
                     torch.full((), _INT32_MAX, dtype=torch.int32,
                                device=q2.device))
    s = torch.sort(qm, dim=1).values.to(torch.int64)
    m = valid2.sum(dim=1)
    lo_i = torch.clamp(m - 1, min=0) // 2
    hi_i = torch.clamp(m // 2, max=V - 1)
    lo = torch.gather(s, 1, lo_i[:, None])[:, 0]
    hi = torch.gather(s, 1, hi_i[:, None])[:, 0]
    # (hi - lo) wraps to int32 before the floor division, as in the
    # reference's int32 arithmetic; the sum wraps again
    half = torch.div(_wrap32(hi - lo).to(torch.int64), 2,
                     rounding_mode="floor")
    center = _wrap32(lo + half)
    return torch.where(m > 0, center, torch.zeros_like(center))


@functools.lru_cache(maxsize=256)
def center_scratch_bytes(C: int, V: int) -> int:
    """Bytes of a dq_center launch's scratch over C rows of V values, from
    the built kernel library (csrc/center.cu owns its layout)."""
    fn = _build.function("ceaz_dq_center_scratch_bytes", [_I64, _I64])
    fn.restype = _I64
    return fn(C, V)


def dq_center_cuda(q2: torch.Tensor, valid2: torch.Tensor) -> torch.Tensor:
    """csrc/center.cu: a range pass, then up to three 12-bit digit passes
    select both middle ranks of every row at once."""
    dispatch.require_cuda("dq_center", q2, valid2)
    if q2.dtype != torch.int32 or valid2.dtype != torch.bool \
            or q2.ndim != 2 or valid2.shape != q2.shape:
        raise ValueError("dq_center: q2 (C, V) int32 and valid2 (C, V) bool "
                         "expected")
    C, V = q2.shape
    dev = q2.device
    if C == 0 or V == 0:
        return torch.zeros(C, dtype=torch.int32, device=dev)
    q2, valid2 = q2.contiguous(), valid2.contiguous()
    centers = torch.empty(C, dtype=torch.int32, device=dev)
    scratch = torch.empty(center_scratch_bytes(C, V), dtype=torch.uint8,
                          device=dev)
    dispatch.count_launch("dq_center")
    rc = _build.function("ceaz_dq_center", _CENTER_ARGS)(
        q2.data_ptr(), valid2.data_ptr(), C, V, scratch.data_ptr(),
        centers.data_ptr(), dispatch.stream_handle())
    _build.check(rc, "dq_center")
    return centers
