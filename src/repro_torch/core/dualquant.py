"""Dual-quantization with Lorenzo prediction: numpy host half + torch twins.

The torch functions reproduce the JAX package's f32 device semantics
step by step (``prequantize``: correctly rounded ``x / (2eb)``,
round-half-even, clip to +-2e9 in f32, ``x - q*2eb`` rounded once as
the fused multiply-add XLA emits, the +-1 nudge in f32, then the int
cast) so a torch pass and a jnp pass over
the same f32 input give the same integers bit for bit. Two integer
rules carry that across frameworks:

  * XLA's float->int32 cast sends NaN to 0; torch's CPU cast gives
    INT32_MIN, so :func:`prequantize` sends NaN to 0 explicitly.
  * jnp int32 arithmetic wraps; torch promotes cumsums to int64 and
    leaves int32 overflow to C++. Every Lorenzo sum here runs in int64
    and is cast back with ``.to(torch.int32)``, which wraps mod 2^32 —
    the same residue as the reference's wrapped int32 chain.

The numpy half (``value_range``, ``np_dual_quantize``, ``np_dequantize``,
``np_value_quantize``, ``np_value_dequantize``) is a copy of the
reference's host twins; the offline codebook build and the facade's
predictor probe use it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

RADIUS = 512          # quantization-code radius -> 1024 symbols
NUM_SYMBOLS = 2 * RADIUS
OUTLIER_CODE = 0      # escape symbol: delta stored out-of-band


def value_range(x: np.ndarray) -> float:
    """max - min as a python float: the relative-bound scale. Python
    floats make inf - inf a quiet NaN (numpy scalars warn, and warnings
    from this package are errors in the tests); NaN/zero ranges fall
    back to 1.0 so non-finite or constant arrays still get a finite
    bound."""
    vrange = float(np.max(x)) - float(np.min(x))
    return vrange if np.isfinite(vrange) and vrange != 0.0 else 1.0


# ---------------------------------------------------------------------------
# torch twins of the f32 device path
# ---------------------------------------------------------------------------

def f32_scalar(v: float, device) -> torch.Tensor:
    """A 0-d float32 tensor: the reference traces `eb` as an f32 scalar,
    so every formula that reads it must see f32(eb), not the double."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def prequantize(x: torch.Tensor, eb) -> torch.Tensor:
    """q = round(x / (2*eb)) as int32, with the f32 bound-tightening
    nudge (see the reference ``core/dualquant.py::prequantize``). `eb`
    is a float or a float32 tensor that broadcasts against x (one bound
    per chunk row)."""
    xf = x.to(torch.float32)
    eb32 = (eb.to(torch.float32) if isinstance(eb, torch.Tensor)
            else f32_scalar(eb, xf.device))
    two_eb = eb32 * 2.0
    q = torch.round(xf / two_eb)
    q = torch.clamp(q, -2.0e9, 2.0e9)
    # err = x - q*2eb rounded ONCE to f32: the reference's XLA build
    # contracts this mul-sub into an FMA. The float64 product is exact
    # (24-bit x 24-bit significands) and so is the difference wherever
    # the comparisons below can go either way, so one f32 rounding of
    # the float64 result is the FMA's.
    err = (xf.to(torch.float64)
           - q.to(torch.float64) * two_eb.to(torch.float64)
           ).to(torch.float32)
    q = q + (err > eb32).to(torch.float32) - (err < -eb32).to(torch.float32)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return q.to(torch.int32)


def _shift(a: torch.Tensor, axes) -> torch.Tensor:
    """Shift +1 along each axis in `axes`, zero-filling the front."""
    for ax in axes:
        pad = [0, 0] * a.ndim
        pad[2 * (a.ndim - 1 - ax)] = 1          # F.pad counts from the last axis
        a = torch.nn.functional.pad(a, pad).narrow(ax, 0, a.shape[ax])
    return a


def lorenzo_predict(q: torch.Tensor, ndim: int) -> torch.Tensor:
    """Lorenzo prediction of an int32 field, as int64 (exact; callers
    wrap to int32 where the reference does). Out-of-range neighbours are
    0."""
    if ndim not in (1, 2, 3):
        raise ValueError(f"Lorenzo predictor supports ndim 1..3, got {ndim}")
    if q.ndim != ndim:
        raise ValueError(f"rank mismatch: array rank {q.ndim} vs ndim {ndim}")
    q = q.to(torch.int64)
    if ndim == 1:
        return _shift(q, (0,))
    if ndim == 2:
        return _shift(q, (0,)) + _shift(q, (1,)) - _shift(q, (0, 1))
    return (_shift(q, (0,)) + _shift(q, (1,)) + _shift(q, (2,))
            - _shift(q, (0, 1)) - _shift(q, (0, 2)) - _shift(q, (1, 2))
            + _shift(q, (0, 1, 2)))


def postquantize(q: torch.Tensor, pred: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (codes int32 in [0, 1024), outlier bool, delta int32 wrapped).

    A wrapped delta is an outlier exactly when the exact one is, so the
    code test runs on the wrapped int32 value widened to int64."""
    delta = (q.to(torch.int64) - pred).to(torch.int32)
    code = delta.to(torch.int64) + RADIUS
    outlier = (code < 1) | (code >= NUM_SYMBOLS)
    codes = torch.where(outlier, torch.zeros_like(code), code).to(torch.int32)
    return codes, outlier, delta


def dual_quantize(x: torch.Tensor, eb: float, ndim: int):
    """x -> (codes int32, outlier bool, delta int32, q int32), all of
    x's shape. `q` is the prequantized field (what the inverse Lorenzo
    of `delta` gives back under int32 wrap)."""
    q = prequantize(x, eb)
    codes, outlier, delta = postquantize(q, lorenzo_predict(q, ndim))
    return codes, outlier, delta, q


def inverse_lorenzo(delta: torch.Tensor, ndim: int) -> torch.Tensor:
    """Multi-axis inclusive cumsum over the last `ndim` axes of the field,
    wrapped to int32 (the mod-2^32 residue of the exact int64 sums)."""
    q = delta.to(torch.int64)
    for ax in range(ndim):
        q = torch.cumsum(q, dim=ax)
    return q.to(torch.int32)


def deltas_from_codes(codes: torch.Tensor, outlier_delta_dense: torch.Tensor
                      ) -> torch.Tensor:
    """Merge in-band codes and dense outlier deltas back into the int32
    delta array."""
    inband = codes.to(torch.int32) - RADIUS
    return torch.where(codes == OUTLIER_CODE,
                       outlier_delta_dense.to(torch.int32), inband)


def dequantize(delta: torch.Tensor, eb: float, ndim: int) -> torch.Tensor:
    """delta codes -> reconstructed f32 values (|x_hat - x| <= eb): the
    inverse Lorenzo, times 2 eb in f32 (the reference's f32(eb) doubled,
    exactly)."""
    q = inverse_lorenzo(delta, ndim)
    return q.to(torch.float32) * (2.0 * f32_scalar(eb, q.device))


# ---------------------------------------------------------------------------
# Value-direct quantization (predictor='none'): each value is coded
# against its chunk's centre code instead of a Lorenzo prediction
# ---------------------------------------------------------------------------

def value_postquantize(q: torch.Tensor, center
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (codes int32, outlier bool, delta int32) of q against `center`
    (an int, or an int tensor that broadcasts: (C, 1) for chunk rows).
    delta = q - center wraps mod 2^32 as the reference's int32 does."""
    center = torch.as_tensor(center, device=q.device).to(torch.int64)
    return postquantize(q, center)


def value_quantize(x, eb: float, kernel_impl: str = "auto", device="cuda"):
    """Torch twin of the reference's device ``value_quantize``: the
    f32 cast of x as ONE chunk row through the runtime's value-direct
    pass (value quantize, `dq_center`, value finalize). Runs on the card
    unless `device='cpu'`; raises when no card is present.

    -> (codes int32, outlier bool, delta int32, center int) as numpy."""
    from ..runtime import fused  # local import: fused imports this module
    flat = torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).reshape(-1), dtype=np.float32)).to(
            fused.target_device(device))
    codes, outl, delta, center = value_quantize_tensors(flat, eb,
                                                        kernel_impl)
    return (codes.cpu().numpy(), outl.cpu().numpy(), delta.cpu().numpy(),
            center)


def value_quantize_tensors(flat: torch.Tensor, eb: float,
                           kernel_impl: str = "auto"):
    """:func:`value_quantize` of a flat f32 tensor, leaving the codes,
    outlier flags and deltas on its device (the staged route packs them
    there). -> (codes int32, outlier bool, delta int32, center int)."""
    from ..runtime import fused
    _, codes2, outl2, delta2, _, centers, _ = fused._value_pass(
        flat, eb, 1, flat.numel(), kernel_impl)
    return codes2[0], outl2[0], delta2[0], int(centers[0])


# ---------------------------------------------------------------------------
# Host-side (numpy) twins, copied from the reference
# ---------------------------------------------------------------------------

def np_value_quantize(x: np.ndarray, eb: float):
    """-> (codes u16, outlier mask, delta int64, center int64)."""
    xf = np.asarray(x, dtype=np.float64)
    # non-finite inputs produce NaNs mid-computation by design (they
    # quantize to clipped codes; comparisons against NaN are false, so
    # the tighten step leaves q alone) — not a numerics bug to warn on
    with np.errstate(invalid="ignore"):
        q = np.rint(xf / (2.0 * eb))
        q = np.clip(np.nan_to_num(q), -2.0e18, 2.0e18).astype(np.int64)
        out_dtype = (x.dtype if x.dtype in (np.float32, np.float64)
                     else np.float32)
        recon = (q * (2.0 * eb)).astype(out_dtype).astype(np.float64)
        err = xf - recon
        q = q + (err > eb).astype(np.int64) - (err < -eb).astype(np.int64)
    center = int(np.median(q))
    delta = q - center
    code = delta + RADIUS
    outlier = (code < 1) | (code >= NUM_SYMBOLS)
    codes = np.where(outlier, OUTLIER_CODE, code).astype(np.uint16)
    return codes, outlier, delta, center


def np_value_dequantize(delta: np.ndarray, center: int, eb: float,
                        dtype=np.float32) -> np.ndarray:
    q = delta.astype(np.int64) + center
    return (q.astype(np.float64) * (2.0 * eb)).astype(dtype)


def np_dual_quantize(x: np.ndarray, eb: float, ndim: int):
    xf = np.asarray(x, dtype=np.float64)
    # see np_value_quantize: NaNs mid-computation are the designed
    # escape for non-finite inputs, not a numerics bug to warn on
    with np.errstate(invalid="ignore"):
        q = np.rint(xf / (2.0 * eb))
        q = np.clip(np.nan_to_num(q), -2.0e18, 2.0e18).astype(np.int64)
        # bound-tighten against the output-dtype reconstruction (see
        # prequantize)
        out_dtype = (x.dtype if x.dtype in (np.float32, np.float64)
                     else np.float32)
        recon = (q * (2.0 * eb)).astype(out_dtype).astype(np.float64)
        err = xf - recon
        q = q + (err > eb).astype(np.int64) - (err < -eb).astype(np.int64)

    def shift(a, axes):
        for ax in axes:
            a = np.roll(a, 1, axis=ax)
            idx = [slice(None)] * a.ndim
            idx[ax] = 0
            a = a.copy()
            a[tuple(idx)] = 0
        return a

    if ndim == 1:
        pred = shift(q, (0,))
    elif ndim == 2:
        pred = shift(q, (0,)) + shift(q, (1,)) - shift(q, (0, 1))
    elif ndim == 3:
        pred = (shift(q, (0,)) + shift(q, (1,)) + shift(q, (2,))
                - shift(q, (0, 1)) - shift(q, (0, 2)) - shift(q, (1, 2))
                + shift(q, (0, 1, 2)))
    else:
        raise ValueError(ndim)
    delta = q - pred
    code = delta + RADIUS
    outlier = (code < 1) | (code >= NUM_SYMBOLS)
    codes = np.where(outlier, OUTLIER_CODE, code).astype(np.uint16)
    return codes, outlier, delta


def np_dequantize(delta: np.ndarray, eb: float, ndim: int,
                  dtype=np.float32) -> np.ndarray:
    q = delta.astype(np.int64)
    for ax in range(ndim):
        q = np.cumsum(q, axis=ax)
    return (q.astype(np.float64) * (2.0 * eb)).astype(dtype)
