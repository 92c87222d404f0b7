"""Compression-ratio control: the paper's rate theory + fixed-ratio mode.

CEAZ §3.2.2 derives that for Lorenzo + linear-scaling quantization the
bit-rate after Huffman coding obeys

    B(N * eb) = B(eb) - log2(N)                                   (Eq. 2)

because scaling the error bound by N shrinks the quant-code histogram by N
while keeping its *shape* (each probability mass merges N-to-1). This gives:

  * one-shot error-bound selection: eb' = 2^(B - B_target) * eb after a
    single sampling compression (used for offline codebook alignment);
  * the fixed-ratio mode (CEAZ Fig 4 bottom path): a closed feedback loop
    that nudges eb so the achieved bit-rate tracks the target — giving a
    consistent payload size/throughput, which the FPGA needs for streaming
    and which WE need for static shapes under jit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .huffman import entropy_bits


def predict_eb(eb: float, bitrate: float, target_bitrate: float) -> float:
    """eb' = 2^(B - B_target) * eb  (paper's one-shot rate law)."""
    return eb * (2.0 ** (bitrate - target_bitrate))


def predict_bitrate(bitrate: float, eb: float, new_eb: float) -> float:
    """B' = B - log2(new_eb / eb)."""
    return bitrate - np.log2(new_eb / eb)


def bitrate_from_ratio(ratio: float, word_bits: int = 32) -> float:
    return word_bits / ratio


def ratio_from_bitrate(bitrate: float, word_bits: int = 32) -> float:
    return word_bits / max(bitrate, 1e-9)


@dataclasses.dataclass
class FixedRatioController:
    """Closed-loop error-bound controller for fixed-ratio mode.

    `feedback()` consumes the achieved bit-rate of the chunk just encoded
    and returns the error bound for the next chunk. The multiplicative
    update is the exact inverse of the rate law; `damping` < 1 keeps the
    loop stable on fields whose histogram shape drifts (where the law is
    only locally exact).

    The update moves eb on a log grid of `steps_per_octave` steps per
    octave (the continuous exponent is rounded to the nearest grid
    step). The grid is what makes the speculative fixed-ratio pipeline
    (runtime/fused.py) effective: `predict_next()` forecasts the next
    chunk's bound from the rate law anchored at the last measurement,
    and the forecast lands on the SAME float as the sequential loop
    whenever the predicted and measured bit-rates round to the same
    step — small prediction error then costs nothing at all, instead of
    a guaranteed byte-level mismatch. The grid's bit-rate granularity,
    1/(steps_per_octave*damping) ~ 0.18 bits/value at the defaults, is
    far below the paper's 15% ratio-accuracy envelope (Fig 13).
    """
    target_bitrate: float
    eb: float
    damping: float = 0.7
    min_eb: float = 1e-12
    max_eb: float = 1e12
    steps_per_octave: int = 8
    # last measurement (pre-update eb, achieved bit-rate): the anchor the
    # rate-law forecast in predict_next() extrapolates from
    last_eb: float | None = None
    last_bitrate: float | None = None

    @classmethod
    def from_target_ratio(cls, target_ratio: float, eb0: float,
                          word_bits: int = 32, **kw) -> "FixedRatioController":
        return cls(target_bitrate=bitrate_from_ratio(target_ratio, word_bits),
                   eb=eb0, **kw)

    def _step(self, eb: float, achieved_bitrate: float) -> float:
        """The pure update rule shared by feedback() and predict_next():
        bitwise-deterministic so a correct forecast replays exactly."""
        err = achieved_bitrate - self.target_bitrate  # positive => too many bits
        k = round(self.steps_per_octave * self.damping * err)
        # clamp the octave shift before the pow: a pathological chunk
        # (per-chunk overheads on a 1-value chunk) can ask for 2^3000,
        # which overflows the float pow long before the eb clamp below
        # would saturate it anyway
        shift = min(max(k / self.steps_per_octave, -1000.0), 1000.0)
        return float(np.clip(eb * 2.0 ** shift, self.min_eb, self.max_eb))

    def feedback(self, achieved_bitrate: float) -> float:
        self.last_eb, self.last_bitrate = self.eb, float(achieved_bitrate)
        self.eb = self._step(self.eb, achieved_bitrate)
        return self.eb

    def predict_next(self, eb: float) -> float:
        """Forecast the bound AFTER a chunk encoded at `eb`, without
        consuming any feedback (pure — controller state is untouched).

        The chunk's bit-rate is forecast by the rate law (Eq. 2)
        anchored at the last measured (eb, bitrate) pair; before any
        measurement the seed eb is assumed on-target (it was calibrated
        to be). The speculative pipeline compares the value returned
        here against the sequential `feedback()` chain with `==` — a
        bitwise hit means the speculatively encoded chunk is committed.
        """
        if self.last_bitrate is None:
            predicted = self.target_bitrate
        else:
            predicted = self.last_bitrate - float(np.log2(eb / self.last_eb))
        return self._step(eb, predicted)


def calibrate_eb_for_bitrate(sample: np.ndarray, target_bitrate: float,
                             ndim: int, rel_eb0: float = 1e-4,
                             iters: int = 2) -> float:
    """One-shot (optionally refined) eb estimation from a sample block.

    Compress-estimates entropy at a probe eb, then applies the rate law.
    With iters>1, re-probes at the predicted eb (protects against the
    histogram-shape drift at very large bounds the paper notes).
    """
    from .dualquant import np_dual_quantize, value_range

    sample = np.asarray(sample)
    eb = rel_eb0 * value_range(sample)
    for _ in range(iters):
        codes, outlier, _ = np_dual_quantize(sample, eb, ndim)
        freqs = np.bincount(codes.reshape(-1), minlength=1024)
        b = entropy_bits(freqs) + 32.0 * outlier.mean()   # escape cost
        eb = predict_eb(eb, b, target_bitrate)
    return float(eb)
