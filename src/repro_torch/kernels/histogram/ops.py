"""The `histogram` op: per-row 1024-bin histograms of quant codes.

    histogram(codes2, valid2) -> hists (C, 1024) int32

codes2 (C, n) int32, valid2 (C, n) bool. A code outside [0, 1024) or at
an invalid position counts nowhere (the reference kernel's one-hot
compare drops its -1 padding sentinel, ``histogram/ops.py:17-24``);
counts are exact.

  * :func:`histogram_plain` — plain PyTorch: one ``torch.bincount`` over
    row-keyed codes, with everything that counts nowhere sent to one
    spare bin past the last row's;
  * :func:`histogram_cuda`  — the kernel of csrc/histogram.cu.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .. import dispatch

NUM_SYMBOLS = 1024
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGS = [_P, _P, _I64, _I64, _P, _P]


def histogram_plain(codes2: torch.Tensor, valid2: torch.Tensor
                    ) -> torch.Tensor:
    C = codes2.shape[0]
    codes = codes2.to(torch.int64)
    rows = torch.arange(C, device=codes2.device)[:, None] * NUM_SYMBOLS
    counted = valid2 & (codes >= 0) & (codes < NUM_SYMBOLS)
    keys = torch.where(counted, rows + codes, C * NUM_SYMBOLS)
    hists = torch.bincount(keys.reshape(-1),
                           minlength=C * NUM_SYMBOLS + 1)
    return hists[:C * NUM_SYMBOLS].reshape(C, NUM_SYMBOLS).to(torch.int32)


def histogram_cuda(codes2: torch.Tensor, valid2: torch.Tensor
                   ) -> torch.Tensor:
    """csrc/histogram.cu: a shared-memory sub-histogram per CTA, added
    into the row's output with integer atomics."""
    dispatch.require_cuda("histogram", codes2, valid2)
    if codes2.dtype != torch.int32 or valid2.dtype != torch.bool \
            or codes2.ndim != 2 or valid2.shape != codes2.shape:
        raise ValueError("histogram: codes2 (C, n) int32 and valid2 (C, n) "
                         "bool expected")
    C, n = codes2.shape
    out = torch.zeros((C, NUM_SYMBOLS), dtype=torch.int32,
                      device=codes2.device)
    if C == 0 or n == 0:
        return out
    dispatch.count_launch("histogram")
    rc = _build.function("ceaz_histogram", _ARGS)(
        codes2.data_ptr(), valid2.data_ptr(), C, n, out.data_ptr(),
        dispatch.stream_handle())
    _build.check(rc, "histogram")
    return out
