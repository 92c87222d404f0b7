"""CEAZ compressor facade (PyTorch port): the fused and staged routes.

Same records and policy as the reference facade (``src/repro/core/
ceaz.py``). Error-bounded modes (``mode='abs'|'rel'``):
``CEAZ.compress`` dual-quantizes with native-rank Lorenzo or
value-direct prediction (``predictor='lorenzo'|'none'|'auto'``).
Fixed-ratio mode (``mode='fixed_ratio'``) treats the array as a 1-D
stream of chunks whose bound adapts per chunk so the payload tracks
``target_ratio``; it ignores ``predictor`` (Lorenzo). Chunks are coded
with the adaptive chi policy or, with ``codebook='bank'``, with
per-chunk books from an offline CodebookBank (falling back to the exact
route on drift).

Two routes, one stream:

  * fused (``use_fused=True``, the default): batched device passes
    (``runtime/fused.py``); fixed ratio speculates the bound chain in
    windows (``speculation``). Bit-identical to the reference's
    ``CEAZ(use_fused=True)``.
  * staged (``use_fused=False``): the reference's host-staged loop,
    chunk by chunk — quantize, histogram, the host policy, Huffman
    encode, outliers — with the per-value work on ``backend``:
    ``'torch'`` (the default) runs the kernel ops on ``device`` and is
    bit-identical to the reference's ``'jax'`` and ``'pallas'`` (and so
    to the fused route); ``'numpy'`` is the reference's float64/int64
    host reference, bit-identical to its ``'numpy'``. The two differ
    where compiled XLA's fused multiply-add in ``x - q*2eb`` rounds once
    and numpy rounds twice (f32 midpoints).

``decompress`` inverts a stream through the decode megakernel or, with
``decode_megakernel='split'``, through the `hufdec` walk and plain
torch inverse passes; streams those routes do not take (any stream when
``use_fused=False``, or an offline codebook whose length limit is not
16) take the staged host decoder, as in the reference.

The work runs on ``CEAZConfig.device`` — the card unless the caller
asks for the CPU. A batch over a sharding plan of several ranks is
compressed a block of shards a batch position, on that position's rank
(``compress_batch``).
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
                       AdaptiveCoder, AdaptiveDecision, BankCoder,
                       CodebookBank)
from .huffman import NUM_SYMBOLS, Codebook, decode, encode
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

    ``use_fused=False`` takes the staged route; its ``backend`` is
    ``'torch'`` (the kernel ops on ``device``; the reference's ``'jax'``
    and ``'pallas'``) or ``'numpy'`` (the reference's host reference,
    run only when asked). The reference defaults to ``'numpy'`` because
    its staged route is its oracle on the host; the port's staged route
    exists to run on the card, so it defaults to ``'torch'``.
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
    backend: str = "torch"            # staged route: 'torch' | 'numpy'
    predictor: str = "lorenzo"        # 'lorenzo' | 'none' | 'auto'
    use_fused: bool = True            # False: the staged route
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
        if cfg.backend not in ("torch", "numpy"):
            raise ValueError(
                f"backend must be 'torch' or 'numpy', got {cfg.backend!r} "
                "(the reference's 'jax' and 'pallas' are 'torch' here)")
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
          ValueError: unknown ``cfg.mode``, ``cfg.codebook``,
            ``cfg.backend`` or ``cfg.kernel_impl``.
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
        """Mode, route and predictor routing for one array, under a
        given coder."""
        if self.cfg.mode == "fixed_ratio":
            return self._compress_fixed_ratio(x, coder)
        eb = self._abs_eb(x)
        pred = self._pick_predictor(x, eb)
        if not self.cfg.use_fused:
            if pred == "none":
                return self._compress_eb_direct(x, coder)
            return self._compress_eb(x, coder)
        return self._compress_eb_fused(x, pred, coder, eb)

    def _compress_eb_fused(self, x: np.ndarray, predictor: str,
                           coder=None, eb: Optional[float] = None
                           ) -> CEAZCompressed:
        """The fused abs/rel route: the single-pass bank route for a
        BankCoder, the exact two-pass route else."""
        from ..runtime import fused
        coder = coder if coder is not None else self._coder()
        eb = self._abs_eb(x) if eb is None else eb
        chunk_values = self._chunk_values(x.dtype.itemsize * 8)
        if isinstance(coder, BankCoder):
            return fused.compress_error_bounded_bank(
                x, eb, self.cfg.mode, coder, chunk_values,
                self.cfg.block_size, device=self.device,
                kernel_impl=self.cfg.kernel_impl, predictor=predictor)
        return fused.compress_error_bounded(
            x, eb, self.cfg.mode, coder, chunk_values, self.cfg.block_size,
            device=self.device, adaptive=self.cfg.adaptive,
            exact_build=self.cfg.exact_build,
            kernel_impl=self.cfg.kernel_impl, predictor=predictor)

    def _compress_fixed_ratio(self, x: np.ndarray, coder) -> CEAZCompressed:
        """The bound chain starts from the rate law calibrated on the
        first chunk; each chunk's achieved bit-rate steps the controller
        (the fused route speculates the chain in windows)."""
        from ..runtime import fused
        word_bits = x.dtype.itemsize * 8
        flat = x.reshape(-1)
        target_b = bitrate_from_ratio(self.cfg.target_ratio, word_bits)
        cv = self._chunk_values(word_bits)
        eb = calibrate_eb_for_bitrate(flat[:min(len(flat), cv)], target_b, 1)
        ctrl = FixedRatioController(target_bitrate=target_b, eb=eb)
        if self.cfg.use_fused:
            return fused.compress_fixed_ratio(
                x, ctrl, coder, cv, self.cfg.block_size, device=self.device,
                adaptive=self.cfg.adaptive,
                exact_build=self.cfg.exact_build,
                kernel_impl=self.cfg.kernel_impl,
                speculation=self.cfg.speculation)
        src = self._staged_input(flat)
        chunks, lit_idx, lit_val = [], [], []
        for s in range(0, len(flat), cv):
            e = min(s + cv, len(flat))
            codes, outlier, delta = self._dual_quantize(src[s:e], ctrl.eb, 1)
            ch = self._encode_chunk(codes, delta, outlier, ctrl.eb, coder)
            rec = dq.np_dequantize(_host(delta), ctrl.eb, 1, dtype=x.dtype)
            viol = np.flatnonzero(np.abs(rec.astype(np.float64)
                                         - flat[s:e].astype(np.float64))
                                  > ctrl.eb)
            lit_idx.append(viol + s)
            lit_val.append(flat[s:e][viol])
            chunks.append(ch)
            ctrl.feedback(ch.total_bits() / ch.n_values)
        return CEAZCompressed(shape=x.shape, dtype=str(x.dtype), ndim=1,
                              mode="fixed_ratio", chunks=chunks,
                              word_bits=word_bits,
                              literal_idx=np.concatenate(lit_idx)
                              .astype(np.int64),
                              literal_val=np.concatenate(lit_val))

    # -- the staged route (use_fused=False) ------------------------------------
    def _staged_input(self, a: np.ndarray):
        """The staged route's input: the host array itself on 'numpy',
        its f32 cast on the facade's device on 'torch'."""
        if self.cfg.backend == "numpy":
            return a
        return torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.float32)).to(self.device)

    def _dual_quantize(self, work, eb: float, ndim: int):
        """-> (codes, outlier, delta) of the work field: numpy arrays of
        its shape on 'numpy' (int64 delta), flat tensors on its device
        through the `dualquant` op on 'torch' (int32 delta)."""
        if self.cfg.backend == "numpy":
            return dq.np_dual_quantize(work, eb, ndim)
        from ..runtime import fused
        codes2, outl2, delta2, _, _ = fused._quantize_pass(
            work, eb, ndim, 1, work.numel(), self.cfg.kernel_impl)
        return codes2[0], outl2[0], delta2[0]

    def _value_quantize(self, chunk, eb: float):
        """Per-chunk value-direct quantization: the float64/int64 host
        reference on 'numpy', the runtime's value-direct ops (f32
        quantize, `dq_center`, finalize) on 'torch' — the fused route
        batches the same ops, so the two routes agree bit for bit."""
        if self.cfg.backend == "numpy":
            return dq.np_value_quantize(chunk, eb)
        return dq.value_quantize_tensors(chunk, eb, self.cfg.kernel_impl)

    def _encode_chunk(self, codes_flat, delta_flat, outlier_flat, eb: float,
                      coder) -> CompressedChunk:
        """One chunk: its histogram, the host policy, the Huffman
        encode and the outlier escapes — numpy on 'numpy'; the
        `histogram` op, ``encode_device`` and a device compaction on
        'torch'."""
        from ..kernels import dispatch
        from ..kernels.hufenc.ops import encode_device
        from ..runtime import fused
        bs = self.cfg.block_size
        impl = self.cfg.kernel_impl
        numpy = self.cfg.backend == "numpy"
        if numpy:
            freqs = np.bincount(codes_flat, minlength=NUM_SYMBOLS)
        else:
            freqs = fused._chunk_hists(
                codes_flat[None],
                dispatch.all_valid(codes_flat.numel(), codes_flat.device),
                impl)[0].cpu().numpy().astype(np.int64)
        if isinstance(coder, BankCoder) or self.cfg.adaptive:
            decision = coder.step(freqs)
        else:
            cb = Codebook.from_freqs(freqs, exact=self.cfg.exact_build)
            decision = AdaptiveDecision("rebuild", 0.0, cb, True)
        if numpy:
            words, block_nbits, _ = encode(codes_flat, decision.codebook, bs)
            oidx = np.flatnonzero(outlier_flat)
            odelta = delta_flat[oidx]
        else:
            words, block_nbits, _ = encode_device(
                codes_flat, decision.codebook, bs, freqs=freqs,
                kernel_impl=impl)
            oidx_t = torch.nonzero(outlier_flat).reshape(-1)
            odelta = delta_flat[oidx_t].cpu().numpy()
            oidx = oidx_t.cpu().numpy()
        return CompressedChunk(
            words=words, block_nbits=block_nbits, n_values=len(codes_flat),
            eb=eb, action=decision.action, chi=decision.chi,
            codebook_lengths=(decision.codebook.lengths.copy()
                              if decision.stored_codebook else None),
            codebook_id=decision.codebook.id,
            outlier_idx=oidx.astype(np.int64),
            outlier_delta=odelta.astype(np.int32),
            bank_ref=decision.bank_ref, bank_index=decision.bank_index)

    def _compress_eb(self, x: np.ndarray, coder) -> CEAZCompressed:
        """Staged Lorenzo: quantize the whole array (native rank <= 3),
        encode it chunk by chunk, and replay the float64 reconstruction
        on the host for the literal channel."""
        word_bits = x.dtype.itemsize * 8
        ndim = min(x.ndim, 3)
        work = x if x.ndim <= 3 else x.reshape((-1,) + x.shape[-2:])
        eb = self._abs_eb(x)
        codes, outlier, delta = self._dual_quantize(
            self._staged_input(work), eb, ndim)
        codes_f = codes.reshape(-1)
        delta_f = delta.reshape(-1)
        outl_f = outlier.reshape(-1)
        cv = self._chunk_values(word_bits)
        chunks = []
        for s in range(0, len(codes_f), cv):
            e = min(s + cv, len(codes_f))
            chunks.append(self._encode_chunk(codes_f[s:e], delta_f[s:e],
                                             outl_f[s:e], eb, coder))
        rec = dq.np_dequantize(_host(delta).reshape(work.shape), eb, ndim,
                               dtype=x.dtype).reshape(-1)
        viol = np.flatnonzero(np.abs(rec.astype(np.float64)
                                     - x.reshape(-1).astype(np.float64)) > eb)
        return CEAZCompressed(shape=x.shape, dtype=str(x.dtype), ndim=ndim,
                              mode=self.cfg.mode, chunks=chunks,
                              word_bits=word_bits,
                              literal_idx=viol.astype(np.int64),
                              literal_val=x.reshape(-1)[viol].copy())

    def _compress_eb_direct(self, x: np.ndarray, coder) -> CEAZCompressed:
        """Staged value-direct (predictor='none'): each chunk quantized
        against its own centre code."""
        word_bits = x.dtype.itemsize * 8
        flat = x.reshape(-1)
        eb = self._abs_eb(x)
        cv = self._chunk_values(word_bits)
        src = self._staged_input(flat)
        chunks, lit_idx, lit_val = [], [], []
        for s in range(0, len(flat), cv):
            e = min(s + cv, len(flat))
            codes, outlier, delta, center = self._value_quantize(src[s:e], eb)
            ch = self._encode_chunk(codes.reshape(-1), delta.reshape(-1),
                                    outlier.reshape(-1), eb, coder)
            ch.center = center
            rec = dq.np_value_dequantize(_host(delta), center, eb,
                                         dtype=x.dtype)
            viol = np.flatnonzero(
                np.abs(rec.astype(np.float64)
                       - flat[s:e].astype(np.float64)) > eb)
            lit_idx.append(viol + s)
            lit_val.append(flat[s:e][viol])
            chunks.append(ch)
        return CEAZCompressed(
            shape=x.shape, dtype=str(x.dtype), ndim=1, mode=self.cfg.mode,
            chunks=chunks, word_bits=word_bits, predictor="none",
            literal_idx=np.concatenate(lit_idx).astype(np.int64),
            literal_val=np.concatenate(lit_val))

    # -- batches ---------------------------------------------------------------
    def compress_batch(self, shards, plan=None) -> List[CEAZCompressed]:
        """Compress a sequence of shards under this facade's policy.

        With ``use_fused``, error-bounded shards are grouped by (shape,
        dtype, resolved predictor) and every group of two or more runs
        as ONE pass pair (``runtime/fused.py::batch_compress``), each
        shard with its own adaptive coder. Everything left over (ragged
        shapes, singletons, bank mode, fixed ratio, ``use_fused=False``)
        takes per-shard :meth:`compress` (or the fused route directly
        for a singleton whose predictor is already resolved). Returns
        one stream per shard, in order, each bit-identical to the
        shard's own :meth:`compress`.

        ``plan``: None, or a ``runtime/sharding.py::ShardingPlan``. With
        a rank mesh (several processes) each batch position's rank
        compresses its contiguous block of shards and every rank returns
        the whole list (``runtime/sharding.py::distribute``); with a
        logical mesh the batched passes run on the device it names. The
        streams are those of ``plan=None`` either way. Raises otherwise
        as :meth:`compress`.
        """
        from ..runtime import fused
        from ..runtime.sharding import distribute, is_rank_plan, plan_device
        plan_device(plan, "compress_batch")
        if is_rank_plan(plan):
            return distribute(list(shards), plan,
                              lambda blk: self.compress_batch(blk))
        shards = [np.asarray(s) for s in shards]
        out: List[Optional[CEAZCompressed]] = [None] * len(shards)
        preds: dict = {}               # probe once; leftovers reuse it
        if self.cfg.use_fused and self.cfg.mode in ("abs", "rel") \
                and not self._bank_mode():
            self._check_route()
            # bank mode routes per shard through compress(): the drift
            # fallback decides per array
            groups: dict = {}
            for i, s in enumerate(shards):
                if s.dtype not in (np.float32, np.float64) or s.size == 0:
                    continue        # compress() raises/handles below
                preds[i] = self._pick_predictor(s, self._abs_eb(s))
                groups.setdefault((s.shape, s.dtype, preds[i]),
                                  []).append(i)
            for (_, dtype, pred), idxs in groups.items():
                if len(idxs) < 2:
                    continue        # per-shard fused compress below
                with ot.span("ceaz.batch_fused_pass", n=len(idxs),
                             predictor=pred):
                    outs = fused.batch_compress(
                        [shards[i] for i in idxs], self.cfg.eb,
                        self._chunk_values(dtype.itemsize * 8),
                        self.cfg.block_size, self.offline,
                        mode=self.cfg.mode, device=self.device,
                        plan=plan, tau0=self.cfg.tau0, tau1=self.cfg.tau1,
                        adaptive=self.cfg.adaptive,
                        exact_build=self.cfg.exact_build,
                        kernel_impl=self.cfg.kernel_impl, predictor=pred)
                for i, c in zip(idxs, outs):
                    out[i] = c
        # counters: shards routed through compress() count there;
        # batched / per-shard fused results count here
        return [self._note_compressed(s, c) if c is not None
                else (self._note_compressed(
                          s, self._compress_eb_fused(s, preds[i]))
                      if i in preds else self.compress(s))
                for i, (c, s) in enumerate(zip(out, shards))]

    # -- decode side -----------------------------------------------------------
    def decompress(self, c: CEAZCompressed) -> np.ndarray:
        """Decode one stream to an array of its original shape and dtype.

        Raises:
          ValueError: the stream's per-chunk block counts are
            inconsistent with ``cfg.block_size``.
        """
        return self.decompress_batch([c])[0]

    def decompress_batch(self, comps) -> List[np.ndarray]:
        """Decode a sequence of streams. With ``use_fused``, all
        eligible streams share ONE batched pass: the `ceaz_chunk_dec`
        op, or with ``decode_megakernel='split'`` the `hufdec` walk; the
        rest take the staged host decoder. Returns arrays in input
        order."""
        comps = list(comps)
        dmk = self.cfg.decode_megakernel
        if dmk not in ("auto", "mega", "split"):
            raise ValueError(f"unknown decode_megakernel {dmk!r}; choose "
                             "from ('auto', 'mega', 'split')")
        from ..runtime import fused_decode as FD
        out: List[Optional[np.ndarray]] = [None] * len(comps)
        with ot.span("ceaz.decompress_batch", n=len(comps)):
            idx = ([i for i, c in enumerate(comps)
                    if FD.fused_decode_ok(c, self.offline)]
                   if self.cfg.use_fused else [])
            for i in idx:
                self._check_block_size(comps[i])
            if idx:
                dec = FD.decompress_batch(
                    [comps[i] for i in idx], self.cfg.block_size,
                    self.offline, device=self.device,
                    kernel_impl=self.cfg.kernel_impl, bank=self.bank,
                    megakernel=dmk != "split")
                for i, a in zip(idx, dec):
                    out[i] = a
            # the rest (empty streams, use_fused off, books the fused
            # routes do not take) decode on the staged host route
            out = [a if a is not None else self._decompress_staged(c)
                   for a, c in zip(out, comps)]
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

    def _decompress_staged(self, c: CEAZCompressed) -> np.ndarray:
        """The host-staged decoder (the reference's bit-exactness
        oracle): the table walk of ``huffman.decode`` per chunk, the
        outlier patch and the float64 inverse, all numpy."""
        from .huffman import replay_codebooks
        self._check_block_size(c)
        out_dtype = np.dtype(c.dtype)
        if not c.chunks:                     # empty stream: zero values
            return np.zeros(c.shape, dtype=out_dtype)
        books = replay_codebooks(c.chunks, self.offline, bank=self.bank)
        deltas = []
        for ch, cb in zip(c.chunks, books):
            codes = decode(ch.words, ch.block_nbits, ch.n_values,
                           self.cfg.block_size, cb)
            d = codes.astype(np.int64) - dq.RADIUS
            d[ch.outlier_idx] = ch.outlier_delta
            deltas.append(d)
        if c.predictor == "none":
            rec = np.concatenate([
                dq.np_value_dequantize(d, ch.center, ch.eb, dtype=out_dtype)
                for d, ch in zip(deltas, c.chunks)])
        elif c.mode in ("abs", "rel"):
            work_shape = (c.shape if len(c.shape) <= 3
                          else (-1,) + c.shape[-2:])
            rec = dq.np_dequantize(np.concatenate(deltas).reshape(work_shape),
                                   c.chunks[0].eb, c.ndim,
                                   dtype=out_dtype).reshape(-1)
        else:
            rec = np.concatenate([
                dq.np_dequantize(d, ch.eb, 1, dtype=out_dtype)
                for d, ch in zip(deltas, c.chunks)])
        rec[c.literal_idx] = c.literal_val.astype(out_dtype)
        return rec.reshape(c.shape)


def compress(x, **kw) -> CEAZCompressed:
    """``CEAZ(**kw).compress(x)``."""
    return CEAZ(**kw).compress(x)


def decompress(c: CEAZCompressed, **kw) -> np.ndarray:
    """``CEAZ(**kw).decompress(c)``."""
    return CEAZ(**kw).decompress(c)


def _host(a) -> np.ndarray:
    """A staged-route array on the host (a device tensor's copy)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else a
