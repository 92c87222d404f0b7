"""The `histogram` op: per-row 1024-bin histograms of quant codes.

    histogram(codes2, valid2) -> hists (C, 1024) int32

codes2 (C, n) int32, valid2 (C, n) bool. A code outside [0, 1024) or at
an invalid position counts nowhere (the reference kernel's one-hot
compare drops its -1 padding sentinel, ``histogram/ops.py:17-24``);
counts are exact.

  * :func:`histogram_plain` — plain PyTorch: one ``torch.bincount`` over
    row-keyed codes, with everything that counts nowhere sent to one
    spare bin past the last row's;
  * :func:`histogram_cuda`  — the kernel of csrc/histogram.cu, on the
    grid :func:`histogram_grid` sizes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .. import dispatch

NUM_SYMBOLS = 1024
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGS = [_P, _P, _I64, _I64, _I64, _I64, _P, _P]
MAX_GRID_Y = 65535               # CUDA's limit on gridDim.y
MIN_PER_CTA = 4096               # values of one row a CTA counts at least
CTAS_PER_SM = 4                  # the grid's aim where the data allows it


def histogram_grid(C: int, n: int, sms: int):
    """The kernel's grid for C rows of n values on a card of `sms` SMs:
    (values of a row each CTA counts, grid rows); ceil(n / per) CTAs
    count a row.

    The slice is sized from C*n: about CTAS_PER_SM CTAs an SM, at least
    MIN_PER_CTA values a CTA, rounded up to a multiple of 1024. One
    2^15-value row runs on 8 CTAs, one 2^17-value row on 32. Past 65535
    rows the grid's CTAs stride over the rows."""
    per = max(MIN_PER_CTA, -(-C * n // (CTAS_PER_SM * sms)))
    return -(-per // 1024) * 1024, max(1, min(C, MAX_GRID_Y))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    """csrc/histogram.cu: each CTA counts a slice of a row into per-warp
    shared-memory tables (a run of equal codes one atomic), added into
    the row's output with integer atomics."""
    dispatch.require_cuda("histogram", codes2, valid2)
    if codes2.dtype != torch.int32 or valid2.dtype != torch.bool \
            or codes2.ndim != 2 or valid2.shape != codes2.shape:
        raise ValueError("histogram: codes2 (C, n) int32 and valid2 (C, n) "
                         "bool expected")
    C, n = codes2.shape
    if C == 0 or n == 0:
        return torch.zeros((C, NUM_SYMBOLS), dtype=torch.int32,
                           device=codes2.device)
    # zeroed by the C entry, on the stream, before the launch
    out = torch.empty((C, NUM_SYMBOLS), dtype=torch.int32,
                      device=codes2.device)
    per, grid_y = histogram_grid(C, n, _sm_count(codes2.device.index))
    dispatch.count_launch("histogram")
    rc = _build.function("ceaz_histogram", _ARGS)(
        codes2.data_ptr(), valid2.data_ptr(), C, n, per, grid_y,
        out.data_ptr(), dispatch.stream_handle())
    _build.check(rc, "histogram")
    return out
