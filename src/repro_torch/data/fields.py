"""SDRBench-proxy scientific field generators.

The paper evaluates on six SDRBench datasets (HACC, NWChem, Brown, CESM,
S3D, NYX — Table 1). Those datasets are not available offline, so we
generate statistical proxies calibrated to reproduce the ONE property that
anchors an SZ-family compressor's behaviour: the Lorenzo-delta scale at the
paper's reference error bound (value-range-relative 1e-4). Each generator
mixes a normalized smooth structure field with a fine-scale component whose
amplitude is solved analytically (Lorenzo is linear, so delta variances
add) to hit the target quant-code std — chosen so the bitrate at rel-1e-4
matches the paper's reported CR for that dataset:

    dataset   paper CR@1e-4    target bitrate   source
    NWChem    28.2             ~1.1 + spikes    Table 4
    Brown     46.2             ~0.7             Table 4
    CESM       9.1             ~3.5             Table 4
    S3D       30.9             ~1.0             Table 4
    NYX        8.5             ~3.8             Table 8
    HACC      ~8 (ideal cw)    ~4.0             Fig 10

Only this single anchor point is fitted; the eb-scaling law, PSNR,
offline-codeword degradation, adaptivity and throughput behaviours are all
emergent and validated against the paper in EXPERIMENTS.md.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

REF_REL_EB = 1e-4

_SIZES = {
    "small": dict(hacc=(1 << 18,), nwchem=(1 << 18,), brown=(1 << 18,),
                  cesm=(256, 512), s3d=(64, 64, 64), nyx=(64, 64, 64)),
    # 'bench': ~8 MB/field — large enough for multi-chunk adaptivity and
    # stable statistics, small enough for the CPU-bound harness
    "bench": dict(hacc=(1 << 21,), nwchem=(1 << 21,), brown=(1 << 21,),
                  cesm=(1024, 2048), s3d=(128, 128, 128),
                  nyx=(128, 128, 128)),
    "medium": dict(hacc=(1 << 23,), nwchem=(1 << 23,), brown=(1 << 22,),
                   cesm=(1800, 3600), s3d=(256, 256, 256),
                   nyx=(256, 256, 256)),
}

# target std of the Lorenzo delta IN QUANT UNITS at rel eb 1e-4; entropy of
# a discrete Gaussian sigma is ~0.5*log2(2*pi*e*sigma^2), inverted from the
# bitrates above.
_TARGET_SIGMA = dict(hacc=3.9, nwchem=0.55, brown=0.35, cesm=2.7,
                     s3d=0.5, nyx=3.4)


def _spectral_field(shape, beta: float, rng: np.random.Generator) -> np.ndarray:
    """Gaussian random field with isotropic power spectrum ~ k^-beta."""
    white = rng.standard_normal(shape).astype(np.float32)
    f = np.fft.rfftn(white)
    grids = np.meshgrid(*[np.fft.fftfreq(n) for n in shape[:-1]]
                        + [np.fft.rfftfreq(shape[-1])], indexing="ij")
    k = np.sqrt(sum(g ** 2 for g in grids))
    k[tuple([0] * len(shape))] = 1.0
    f *= k ** (-beta / 2.0)
    out = np.fft.irfftn(f, s=shape, axes=range(len(shape))).astype(np.float32)
    out -= out.min()
    out /= max(out.max(), 1e-30)          # normalized to range [0, 1]
    return out


def _lorenzo_delta_std(x: np.ndarray) -> float:
    d = x
    for ax in range(x.ndim):
        d = np.diff(d, axis=ax, prepend=0)
    # drop the boundary faces (prepend=0 makes them outsized)
    sl = tuple(slice(1, None) for _ in range(x.ndim))
    return float(d[sl].std())


def _calibrated(smooth: np.ndarray, fine: np.ndarray, name: str) -> np.ndarray:
    """smooth + a*fine with `a` solved so the quant-unit delta std at
    rel-1e-4 hits _TARGET_SIGMA[name]. Lorenzo is linear => variances add."""
    step = 2.0 * REF_REL_EB                      # range is ~1 after normalize
    target = _TARGET_SIGMA[name] * step
    s_smooth = _lorenzo_delta_std(smooth)
    s_fine = _lorenzo_delta_std(fine)
    a = np.sqrt(max(target ** 2 - s_smooth ** 2, 0.0)) / max(s_fine, 1e-30)
    return (smooth + a * fine).astype(np.float32)


def _smooth_base(shape, rng, keep_frac: float = 0.02) -> np.ndarray:
    """Very-low-frequency structure: spectral field truncated to the lowest
    `keep_frac` of modes, so its own Lorenzo delta is tiny."""
    f = _spectral_field(shape, 3.5, rng)
    ft = np.fft.rfftn(f)
    grids = np.meshgrid(*[np.fft.fftfreq(n) for n in shape[:-1]]
                        + [np.fft.rfftfreq(shape[-1])], indexing="ij")
    k = np.sqrt(sum(g ** 2 for g in grids))
    # keep at least a few modes on small grids
    k_keep = max(keep_frac * 0.5, 3.0 / min(shape))
    ft[k > k_keep] = 0
    out = np.fft.irfftn(ft, s=shape, axes=range(len(shape))).astype(np.float32)
    out -= out.min()
    out /= max(out.max(), 1e-30)
    return out


def hacc_proxy(seed: int = 0, size: str = "small") -> np.ndarray:
    """Particle positions: coarse locality + strong small-scale jitter
    => the least Lorenzo-friendly histogram (paper Fig 7/Fig 10)."""
    rng = np.random.default_rng(seed)
    shape = _SIZES[size]["hacc"]
    smooth = _smooth_base(shape, rng)
    fine = rng.standard_normal(shape).astype(np.float32)   # white jitter
    return _calibrated(smooth, fine, "hacc") * 256.0


def nwchem_proxy(seed: int = 1, size: str = "small") -> np.ndarray:
    """Two-electron integrals: near-zero smooth background + sparse spikes."""
    rng = np.random.default_rng(seed)
    shape = _SIZES[size]["nwchem"]
    smooth = _smooth_base(shape, rng)
    fine = _spectral_field(shape, 1.0, rng) - 0.5
    x = _calibrated(smooth, fine, "nwchem")
    spikes = rng.random(shape) < 5e-4
    x = x.copy()
    x[spikes] = rng.uniform(-1.0, 1.0, int(spikes.sum())).astype(np.float32)
    return x


def brown_proxy(seed: int = 2, size: str = "small") -> np.ndarray:
    """Brown samples: fBm-like with prescribed regularity — smoothest."""
    rng = np.random.default_rng(seed)
    shape = _SIZES[size]["brown"]
    smooth = _smooth_base(shape, rng)
    fine = _spectral_field(shape, 2.0, rng) - 0.5
    return _calibrated(smooth, fine, "brown")


def cesm_proxy(seed: int = 3, size: str = "small") -> np.ndarray:
    """2-D climate field: zonal bands + weather-scale variability."""
    rng = np.random.default_rng(seed)
    shape = _SIZES[size]["cesm"]
    base = _smooth_base(shape, rng)
    lat = np.cos(np.linspace(-np.pi / 2, np.pi / 2, shape[0],
                             dtype=np.float32))[:, None]
    smooth = 0.5 * base + 0.5 * np.broadcast_to(lat, shape)
    fine = _spectral_field(shape, 1.6, rng) - 0.5
    return _calibrated(smooth.astype(np.float32), fine, "cesm")


def s3d_proxy(seed: int = 4, size: str = "small") -> np.ndarray:
    """3-D combustion species: very smooth, mildly front-like."""
    rng = np.random.default_rng(seed)
    shape = _SIZES[size]["s3d"]
    smooth = np.tanh(3.0 * (_smooth_base(shape, rng) - 0.5)).astype(np.float32)
    smooth = (smooth - smooth.min()) / (smooth.max() - smooth.min())
    fine = _spectral_field(shape, 2.2, rng) - 0.5
    return _calibrated(smooth, fine, "s3d")


def nyx_proxy(seed: int = 5, size: str = "small") -> np.ndarray:
    """3-D cosmology baryon density: log-normal-ish, mid compressibility."""
    rng = np.random.default_rng(seed)
    shape = _SIZES[size]["nyx"]
    smooth = np.exp(2.0 * _smooth_base(shape, rng)).astype(np.float32)
    smooth = (smooth - smooth.min()) / (smooth.max() - smooth.min())
    fine = _spectral_field(shape, 1.4, rng) - 0.5
    return _calibrated(smooth, fine, "nyx")


def sdrbench_proxy_corpus(seed: int = 0, size: str = "small"
                          ) -> List[Tuple[str, np.ndarray]]:
    return [
        ("hacc", hacc_proxy(seed + 10, size)),
        ("nwchem", nwchem_proxy(seed + 11, size)),
        ("brown", brown_proxy(seed + 12, size)),
        ("cesm", cesm_proxy(seed + 13, size)),
        ("s3d", s3d_proxy(seed + 14, size)),
        ("nyx", nyx_proxy(seed + 15, size)),
    ]
