"""CEAZ compressor facade (PyTorch port): the fused routes.

Same records and policy as the reference facade (``src/repro/core/
ceaz.py``). Error-bounded modes (``mode='abs'|'rel'``):
``CEAZ.compress`` dual-quantizes with native-rank Lorenzo or
value-direct prediction (``predictor='lorenzo'|'none'|'auto'``).
Fixed-ratio mode (``mode='fixed_ratio'``) treats the array as a 1-D
stream of chunks whose bound adapts per chunk so the payload tracks
``target_ratio``; it ignores ``predictor`` (Lorenzo) and speculates the
bound chain in windows (``speculation``). Chunks are coded with the
adaptive chi policy or, with ``codebook='bank'``, with per-chunk books
selected on the device from an offline CodebookBank (falling back to
the exact route on drift). The :class:`CEAZCompressed` returned is
bit-identical to the reference's ``CEAZ(use_fused=True)`` output;
``decompress`` inverts it through the decode megakernel or, with
``decode_megakernel='split'``, through the `hufdec` walk and plain
torch inverse passes.

The work runs on ``CEAZConfig.device`` — the card unless the caller
asks for the CPU. Routes of the reference not yet ported raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from . import dualquant as dq
from ..obs import metrics as om
from ..obs import trace as ot
from .codebook import (DEFAULT_BANK_DRIFT_TOL, DEFAULT_TAU0, DEFAULT_TAU1,
                       AdaptiveCoder, BankCoder, CodebookBank)
from .huffman import NUM_SYMBOLS, Codebook
from .metrics import compression_ratio
from .ratecontrol import (FixedRatioController, bitrate_from_ratio,
                          calibrate_eb_for_bitrate)

CHUNK_HEADER_BITS = 128
BLOCK_COUNT_BITS = 32
OUTLIER_BITS = 64          # 32-bit position + 32-bit delta

value_range = dq.value_range       # re-export: the facade's bound scale


@dataclasses.dataclass
class CompressedChunk:
    words: np.ndarray            # uint64 bitstream
    block_nbits: np.ndarray      # int64 per block
    n_values: int
    eb: float
    action: str                  # which codebook path was taken
    chi: float
    codebook_lengths: Optional[np.ndarray]   # shipped only when rebuilt
    codebook_id: str
    outlier_idx: np.ndarray      # chunk-local positions (int64)
    outlier_delta: np.ndarray    # int32 deltas
    center: int = 0              # value-direct mode: per-chunk centre code
    # bank mode: which book of which codebook bank encoded this chunk
    bank_ref: str = ""
    bank_index: int = -1

    def payload_bits(self) -> int:
        return int(self.block_nbits.sum())

    def total_bits(self) -> int:
        bits = self.payload_bits()
        bits += CHUNK_HEADER_BITS
        bits += BLOCK_COUNT_BITS * len(self.block_nbits)
        bits += OUTLIER_BITS * len(self.outlier_idx)
        if self.codebook_lengths is not None:
            bits += 5 * NUM_SYMBOLS
        return bits


@dataclasses.dataclass
class CEAZCompressed:
    shape: tuple
    dtype: str
    ndim: int                    # Lorenzo rank used
    mode: str
    chunks: List[CompressedChunk]
    word_bits: int = 32
    predictor: str = "lorenzo"   # 'lorenzo' | 'none' (value-direct)
    # raw-literal channel: the rare points where no f32-rounded
    # reconstruction level lies within eb; patched after reconstruction
    literal_idx: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    literal_val: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))

    def total_bits(self) -> int:
        return (sum(c.total_bits() for c in self.chunks)
                + OUTLIER_BITS * len(self.literal_idx))

    @property
    def n_values(self) -> int:
        return int(np.prod(self.shape))

    def ratio(self) -> float:
        return compression_ratio(self.n_values * self.word_bits,
                                 self.total_bits())

    def bitrate(self) -> float:
        return self.total_bits() / max(self.n_values, 1)

    def nbytes(self) -> int:
        return (self.total_bits() + 7) // 8


@dataclasses.dataclass
class CEAZConfig:
    """Compression policy for the :class:`CEAZ` facade.

    ``device`` is where the per-value work runs: ``'cuda'`` (the
    default; the facade raises when no CUDA device is present) or
    ``'cpu'``, where every kernel op takes its plain PyTorch version.
    ``kernel_impl`` picks the op implementations from the dispatch
    registry (``kernels/dispatch.py``): ``'auto'`` (the kernels on the
    card, plain PyTorch on the CPU), ``'cuda'`` or ``'torch'``.
    """
    mode: str = "rel"                 # 'abs' | 'rel' | 'fixed_ratio'
    eb: float = 1e-4                  # absolute or range-relative bound
    target_ratio: float = 10.0        # fixed-ratio mode
    chunk_bytes: int = 1 << 25        # paper Fig 11 optimum: 32 MB
    block_size: int = 4096            # bitstream block (parallel decode unit)
    tau0: float = DEFAULT_TAU0
    tau1: float = DEFAULT_TAU1
    exact_build: bool = False         # True => oracle Huffman
    adaptive: bool = True             # False => always rebuild
    predictor: str = "lorenzo"        # 'lorenzo' | 'none' | 'auto'
    use_fused: bool = True            # ported: the fused route
    # fixed-ratio speculation window: 'auto' (8, then adapted per
    # window), an int >= 1, or 'off' (the sequential loop); the stream
    # never depends on it
    speculation: int | str = "auto"
    kernel_impl: str = "auto"
    # 'auto'/'mega': the decode megakernel; 'split': the `hufdec` walk,
    # then the outlier scatter and inverse as plain torch ops
    decode_megakernel: str = "auto"
    # 'exact' builds/keeps codebooks by the chi policy; 'bank' selects
    # each chunk's book from an offline CodebookBank on the device;
    # 'auto' means 'bank' iff a bank was passed to the facade
    codebook: str = "exact"
    # bank mode's safety valve: when the aggregate achieved/ideal bits
    # drift past this bound the array is recompressed on the exact route
    bank_drift_tol: float = DEFAULT_BANK_DRIFT_TOL
    device: str = "cuda"


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


class CEAZ:
    """The compressor facade: policy + routing.

        comp = CEAZ(CEAZConfig(mode="rel", eb=1e-4))      # on the card
        comp = CEAZ(mode="abs", eb=1e-3, device="cpu")    # plain torch
        comp = CEAZ(codebook="bank")                      # default bank
    """

    def __init__(self, config: CEAZConfig | None = None,
                 offline_codebook: Codebook | None = None,
                 bank: CodebookBank | None = None, **kw):
        if config is None:
            config = CEAZConfig(**kw)
        elif kw:
            config = dataclasses.replace(config, **kw)
        self.cfg = config
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CEAZConfig(device='cuda') but no CUDA device is present; "
                "pass device='cpu' to run the plain PyTorch versions")
        if offline_codebook is None:
            from .codebook import default_offline_codebook
            offline_codebook = default_offline_codebook()
        self.offline = offline_codebook
        if bank is None and config.codebook == "bank":
            from .codebook import default_codebook_bank
            bank = default_codebook_bank()
        self.bank = bank
        if self.bank is not None:
            from .codebook import register_bank
            register_bank(self.bank)   # decode-side bank_ref resolution

    # -- helpers -------------------------------------------------------------
    def _abs_eb(self, x: np.ndarray) -> float:
        if self.cfg.mode == "abs":
            return self.cfg.eb
        return self.cfg.eb * value_range(x)

    def _chunk_values(self, word_bits: int) -> int:
        return max(self.cfg.chunk_bytes // (word_bits // 8),
                   self.cfg.block_size)

    def _coder(self) -> AdaptiveCoder:
        return AdaptiveCoder(self.offline, self.cfg.tau0, self.cfg.tau1,
                             self.cfg.exact_build)

    def _check_route(self):
        cfg = self.cfg
        if not cfg.use_fused:
            _not_ported("the staged route (use_fused=False)",
                        "Queue 1 item 1")
        if cfg.mode not in ("abs", "rel", "fixed_ratio"):
            raise ValueError(cfg.mode)
        if cfg.predictor not in ("lorenzo", "none", "auto"):
            raise ValueError(f"unknown predictor {cfg.predictor!r}")
        self._bank_mode()              # raises on an unknown codebook

    def _bank_mode(self) -> bool:
        """Resolve cfg.codebook: 'bank' always, 'auto' iff a bank was
        handed to the facade, 'exact' never."""
        cb = self.cfg.codebook
        if cb == "bank":
            return True
        if cb == "auto":
            return self.bank is not None
        if cb == "exact":
            return False
        raise ValueError(
            f"codebook must be 'exact', 'bank' or 'auto', got {cb!r}")

    def _pick_predictor(self, x: np.ndarray, eb: float) -> str:
        """'auto': the cheaper of Lorenzo and value-direct on the first
        2^16 values (entropy of the codes plus 64 bits per outlier)."""
        if self.cfg.predictor != "auto":
            return self.cfg.predictor
        from .huffman import entropy_bits as H
        sample = x.reshape(-1)[:1 << 16]
        c_l, o_l, _ = dq.np_dual_quantize(sample, eb, 1)
        c_v, o_v, _, _ = dq.np_value_quantize(sample, eb)
        cost_l = H(np.bincount(c_l, minlength=1024)) + 64 * o_l.mean()
        cost_v = H(np.bincount(c_v, minlength=1024)) + 64 * o_v.mean()
        return "lorenzo" if cost_l <= cost_v else "none"

    # -- public API ------------------------------------------------------------
    def compress(self, x: np.ndarray) -> CEAZCompressed:
        """Compress one float32/float64 array under this facade's policy.

        Raises:
          TypeError: non-float dtype.
          ValueError: unknown ``cfg.mode``, ``cfg.codebook`` or
            ``cfg.kernel_impl``.
          NotImplementedError: a route not ported yet.
        """
        x = np.asarray(x)
        if x.dtype not in (np.float32, np.float64):
            raise TypeError(f"CEAZ compresses float data, got {x.dtype}")
        self._check_route()
        word_bits = x.dtype.itemsize * 8
        if x.size == 0:
            return CEAZCompressed(
                shape=x.shape, dtype=str(x.dtype), ndim=1,
                mode=self.cfg.mode, chunks=[], word_bits=word_bits,
                predictor="none" if self.cfg.predictor == "none"
                else "lorenzo")
        with ot.span("ceaz.compress", shape=list(x.shape),
                     dtype=str(x.dtype), mode=self.cfg.mode):
            if not self._bank_mode():
                return self._note_compressed(
                    x, self._compress_routed(x, self._coder()))
            coder = BankCoder(self.bank)
            c = self._compress_routed(x, coder)
            om.set_gauge(om.BANK_DRIFT, coder.drift())
            if coder.drift() > self.cfg.bank_drift_tol:
                # out-of-distribution input: the whole array goes the
                # exact two-pass route (the drift was replayed on the
                # host from the histograms the bank pass produced)
                om.add(om.BANK_FALLBACKS)
                with ot.span("ceaz.bank_exact_fallback",
                             drift=coder.drift()):
                    return self._note_compressed(
                        x, self._compress_routed(x, self._coder()))
            return self._note_compressed(x, c)

    @staticmethod
    def _note_compressed(x: np.ndarray, c: CEAZCompressed) -> CEAZCompressed:
        """Every finished encode bumps the chunk/byte counters here."""
        om.add(om.CHUNKS, len(c.chunks))
        om.add(om.RAW_BYTES, int(x.nbytes))
        om.add(om.STORED_BYTES, c.nbytes())
        return c

    def _compress_routed(self, x: np.ndarray, coder) -> CEAZCompressed:
        """Mode and predictor routing for one array, under a given coder:
        the single-pass bank route for a BankCoder, the exact route
        else."""
        from ..runtime import fused
        if self.cfg.mode == "fixed_ratio":
            return self._compress_fixed_ratio(x, coder)
        eb = self._abs_eb(x)
        pred = self._pick_predictor(x, eb)
        chunk_values = self._chunk_values(x.dtype.itemsize * 8)
        if isinstance(coder, BankCoder):
            return fused.compress_error_bounded_bank(
                x, eb, self.cfg.mode, coder, chunk_values,
                self.cfg.block_size, device=self.device,
                kernel_impl=self.cfg.kernel_impl, predictor=pred)
        return fused.compress_error_bounded(
            x, eb, self.cfg.mode, coder, chunk_values, self.cfg.block_size,
            device=self.device, adaptive=self.cfg.adaptive,
            exact_build=self.cfg.exact_build,
            kernel_impl=self.cfg.kernel_impl, predictor=pred)

    def _compress_fixed_ratio(self, x: np.ndarray, coder) -> CEAZCompressed:
        """The bound chain starts from the rate law calibrated on the
        first chunk; the runtime steps the controller per chunk."""
        from ..runtime import fused
        word_bits = x.dtype.itemsize * 8
        flat = x.reshape(-1)
        target_b = bitrate_from_ratio(self.cfg.target_ratio, word_bits)
        cv = self._chunk_values(word_bits)
        eb = calibrate_eb_for_bitrate(flat[:min(len(flat), cv)], target_b, 1)
        ctrl = FixedRatioController(target_bitrate=target_b, eb=eb)
        return fused.compress_fixed_ratio(
            x, ctrl, coder, cv, self.cfg.block_size, device=self.device,
            adaptive=self.cfg.adaptive, exact_build=self.cfg.exact_build,
            kernel_impl=self.cfg.kernel_impl,
            speculation=self.cfg.speculation)

    def compress_batch(self, shards, plan=None):
        _not_ported("compress_batch (batch_compress)", "Queue 1 item 2")

    # -- decode side -----------------------------------------------------------
    def decompress(self, c: CEAZCompressed) -> np.ndarray:
        """Decode one stream to an array of its original shape and dtype.

        Raises:
          ValueError: the stream's per-chunk block counts are
            inconsistent with ``cfg.block_size``.
        """
        return self.decompress_batch([c])[0]

    def decompress_batch(self, comps) -> List[np.ndarray]:
        """Decode a sequence of streams; all eligible streams share ONE
        batched pass: the `ceaz_chunk_dec` op, or with
        ``decode_megakernel='split'`` the `hufdec` walk. Returns arrays
        in input order."""
        comps = list(comps)
        dmk = self.cfg.decode_megakernel
        if dmk not in ("auto", "mega", "split"):
            raise ValueError(f"unknown decode_megakernel {dmk!r}; choose "
                             "from ('auto', 'mega', 'split')")
        if not self.cfg.use_fused:
            _not_ported("the staged route (use_fused=False)",
                        "Queue 1 item 1")
        from ..runtime import fused_decode as FD
        out: List[Optional[np.ndarray]] = [None] * len(comps)
        with ot.span("ceaz.decompress_batch", n=len(comps)):
            idx = []
            for i, c in enumerate(comps):
                if not c.chunks:                 # empty stream: zero values
                    out[i] = np.zeros(c.shape, dtype=np.dtype(c.dtype))
                elif FD.fused_decode_ok(c, self.offline):
                    self._check_block_size(c)
                    idx.append(i)
                else:
                    # the reference decodes these on its staged route
                    _not_ported(f"decoding {c.mode}/{c.predictor} "
                                f"{c.dtype} streams (the staged decoder)",
                                "Queue 1 item 1")
            if idx:
                dec = FD.decompress_batch(
                    [comps[i] for i in idx], self.cfg.block_size,
                    self.offline, device=self.device,
                    kernel_impl=self.cfg.kernel_impl, bank=self.bank,
                    megakernel=dmk != "split")
                for i, a in zip(idx, dec):
                    out[i] = a
        for c, a in zip(comps, out):
            om.add(om.DECODED_CHUNKS, len(c.chunks))
            om.add(om.DECODED_BYTES, int(a.nbytes))
        return out

    def _check_block_size(self, c: CEAZCompressed):
        """Decode needs the encoder's block_size: refuse loudly when the
        per-chunk block counts are inconsistent with this facade's."""
        bs = self.cfg.block_size
        for i, ch in enumerate(c.chunks):
            expect = max(1, -(-ch.n_values // bs))
            if len(ch.block_nbits) != expect:
                raise ValueError(
                    f"decode block_size={bs} inconsistent with stream: "
                    f"chunk {i} has {len(ch.block_nbits)} blocks for "
                    f"{ch.n_values} values (expected {expect}); pass the "
                    "block_size the stream was compressed with")
