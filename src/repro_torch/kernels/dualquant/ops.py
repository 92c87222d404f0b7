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
"""
from __future__ import annotations

import ctypes

import torch

from ...core import dualquant as core_dq
from .. import _build
from .. import dispatch

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_DQ1D_ARGS = [_P, _I64, _I64, ctypes.c_float, _P, _P, _P, _P, _P]
_DQ2D_ARGS = [_P, _I64, _I64, _I64, ctypes.c_float, _P, _P, _P, _P, _P]


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
