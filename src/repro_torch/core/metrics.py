"""Quality metrics: CR, RMSE, PSNR (paper Eq. 3), max error."""
from __future__ import annotations

import numpy as np


def compression_ratio(original_bits: float, compressed_bits: float) -> float:
    return original_bits / max(compressed_bits, 1e-9)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def psnr(orig: np.ndarray, recon: np.ndarray) -> float:
    """PSNR = 20 log10((dmax - dmin) / RMSE)  — paper Eq. (3)."""
    orig = np.asarray(orig, dtype=np.float64)
    r = rmse(orig, recon)
    vrange = float(orig.max() - orig.min())
    if r == 0:
        return float("inf")
    return 20.0 * np.log10(vrange / r)


def max_abs_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))
