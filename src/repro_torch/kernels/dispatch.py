"""Backend dispatch for the port's kernel ops.

Each op has two implementations with one calling convention and a
bit-exact output contract:

  * ``'torch'`` — the plain PyTorch version (any device; what a CPU
    tensor always takes);
  * ``'cuda'``  — the hand-written Hopper kernel behind a ctypes wrapper
    (``kernels/_build.py``). It takes CUDA tensors only and raises on
    anything else; it never falls back to the plain version.

Callers resolve through the registry, keyed on ``(op, impl)``:

    fn = dispatch.resolve("hufenc", cfg.kernel_impl, device)

``'auto'`` resolves by the device the data lies on: ``'cuda'`` for a
CUDA device, ``'torch'`` for the CPU. Implementations are registered as
zero-arg loaders and imported on first resolve.

Op calling conventions (tensors on one device):

  dualquant(work, eb, ndim, n_out) -> (codes, outl, delta, q)
      work f32 of rank ndim (1..3); codes/outl/delta flat, zero-padded
      to n_out; q the flat prequantized field (n values)
  hufenc(codes2, valid2, lengths_tbl, cwords_tbl, block_size, w32)
      -> (words (C, w32) int32 holding u32 bits, block_nbits (C, nblocks))
  gather_pack(...) the same call and output; on the card both are one
      launch of one kernel (persistent CTAs taking 4096-symbol tiles by
      ticket, bit offsets by look-back), counted under the TPU kernel each
      op replaces (``gather_pack_tiled``, ``gather_pack``)
  hufenc_flat(codes, lengths, cwords, block_size, total_bits)
      -> (words (2*(nwords+1),) int32 holding u32 bits, nbits (nblocks,))
      the staged route's packer of a large chunk: one flat stream, one
      book, into the host stream; on the card one launch, counted under
      the TPU kernel it replaces (``hufenc``; kernels/hufenc/ops.py)
  histogram(codes2, valid2) -> hists (C, 1024) int32
      per-row histograms of the valid codes in [0, 1024)
      (kernels/histogram/ops.py)
  ceaz_chunk_dec(words2, nbits2, counts, sym2, len2, cb_idx, odelta2,
                 base, seg0, islor, block_size) -> q (C, NB*block_size)
      the decode megakernel op; see kernels/megakernel/ops.py
  hufdec(words2, nbits2, counts, sym_flat, len_flat, cb_idx, block_size)
      -> codes (C, NB*block_size) int32
      the split decode route's table walk: on the card the warp walk with
      one window a row; see kernels/hufdec/ops.py
  ceaz_chunk(work2, prev2, valid2, ebs, bank_lengths, bank_cwords,
             block_size, w32, predictor) -> (q2, codes2, outl2, delta2,
             centers, hists, sel, totals, words, block_nbits)
      the single-pass bank encode op; its steps are ops of their own:
  lorenzo_quant(work2, prev2, valid2, ebs)
      -> (q2, codes2, outl2, delta2, hists)
  value_quant(work2, ebs) -> q2
  value_finalize(q2, valid2, centers) -> (q2, codes2, outl2, delta2, hists)
  bank_select(hists, bank_lengths, bank_cwords)
      -> (sel, totals, lengths_sel, cwords_sel)
  dq_center(q2, valid2) -> centers (C,) int32 (kernels/dualquant/ops.py)
  pack(vals, bits) / unpack(words, bits), pack_flat(x, bits) /
  unpack_flat(words, n, bits), pack_words(q, bits) /
  unpack_words(words, n, bits)
      fixed-width b-bit pack in the TPU kernel's tile layout and in the
      wire path's consecutive layout (kernels/bitpack/ops.py); the CUDA
      versions count launches of ``pack`` and ``unpack``

Launch accounting: every CUDA wrapper adds one to its kernel's count
(:func:`count_launch`) where it launches, and nowhere else, so a run
can show the main path went through the kernels. :func:`measure` feeds
the ``ceaz_kernel_*`` metrics per host-level pass, as the reference's
dispatch layer does.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict, Tuple

import torch

from ..obs import metrics as om
from ..obs import trace as ot

_LOADERS: Dict[Tuple[str, str], Callable[[], Callable]] = {}
_RESOLVED: Dict[Tuple[str, str], Callable] = {}
_LAUNCHES: Dict[str, int] = {}
_LAUNCHES_LOCK = threading.Lock()   # the stream engines launch off-thread


def register(op: str, impl: str, loader: Callable[[], Callable]) -> None:
    """Register `loader` (zero-arg, returns the impl fn) under (op, impl)."""
    _LOADERS[(op, impl)] = loader
    _RESOLVED.pop((op, impl), None)


def available(op: str) -> Tuple[str, ...]:
    """Registered implementation names for `op` (excluding 'auto')."""
    return tuple(sorted(i for (o, i) in _LOADERS if o == op))


def resolve_name(impl: str, device) -> str:
    """The concrete impl `impl` names for data on `device`."""
    device = torch.device(device)
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"kernel_impl 'cuda' needs CUDA tensors, got "
                         f"device {device}")
    return impl


def resolve(op: str, impl: str, device) -> Callable:
    """The implementation of `op` selected by `impl` for `device` (no
    default device: the data's device decides).

    Anything not registered raises ValueError naming the valid choices.
    """
    key = (op, resolve_name(impl, device))
    fn = _RESOLVED.get(key)
    if fn is not None:
        return fn
    loader = _LOADERS.get(key)
    if loader is None:
        ops = sorted({o for (o, _) in _LOADERS})
        if op not in ops:
            raise ValueError(
                f"unknown kernel op {op!r}; registered ops: {ops}")
        raise ValueError(
            f"unknown kernel_impl {impl!r} for op {op!r}; choose from "
            f"{('auto',) + available(op)}")
    fn = _RESOLVED[key] = loader()
    return fn


# -- launch counts -------------------------------------------------------------

def count_launch(kernel: str) -> None:
    """Called by a CUDA wrapper where it launches `kernel`."""
    with _LAUNCHES_LOCK:
        _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + 1


def launches() -> Dict[str, int]:
    """Launch counts per kernel since the last :func:`reset_launches`."""
    with _LAUNCHES_LOCK:
        return dict(_LAUNCHES)


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        _LAUNCHES.clear()


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A CUDA wrapper's guard: every tensor argument must be a contiguous
    CUDA tensor."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


_ALL_VALID: Dict[torch.device, torch.Tensor] = {}


def all_valid(n: int, device) -> torch.Tensor:
    """A (1, n) all-true bool mask on `device`, for an op's `valid2` when
    every value of one row counts: a view of one mask cached per device
    (grown when a longer row asks), so a call makes no tensor of its own.
    Callers only read it."""
    device = torch.device(device)
    mask = _ALL_VALID.get(device)
    if mask is None or mask.numel() < n:
        mask = _ALL_VALID[device] = torch.ones(n, dtype=torch.bool,
                                               device=device)
    return mask[:n].view(1, n)


# -- observability -------------------------------------------------------------
# Per host-level pass: the per-(op, impl) ceaz_kernel_calls_total counter
# and a `kernel.<op>` span. Timing a device pass needs a sync, so it is
# opt-in (CEAZ_KERNEL_TIMING=1 or set_timing(True)) and feeds
# ceaz_kernel_pass_seconds.

_TIMING = os.environ.get("CEAZ_KERNEL_TIMING", "") not in ("", "0")


def set_timing(on: bool) -> None:
    global _TIMING
    _TIMING = bool(on)


@contextlib.contextmanager
def measure(op: str, impl: str, device):
    """Account one host-level invocation of `op`."""
    impl = resolve_name(impl, device)
    om.add(om.KERNEL_CALLS, op=op, impl=impl)
    if not _TIMING:
        with ot.span("kernel." + op, impl=impl):
            yield
        return
    t0 = time.perf_counter()
    with ot.span("kernel." + op, impl=impl, timed=True):
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    om.observe(om.KERNEL_SECONDS, time.perf_counter() - t0,
               op=op, impl=impl)


# -- default implementations ---------------------------------------------------

def _loader(module: str, attr: str) -> Callable[[], Callable]:
    """A zero-arg loader of `attr` from the kernels subpackage `module`."""
    def load() -> Callable:
        import importlib
        return getattr(importlib.import_module(f"{__package__}.{module}"),
                       attr)
    return load


for _op, _module, _plain, _cuda in (
        ("dualquant", "dualquant.ops", "dual_quantize_plain",
         "dual_quantize_cuda"),
        ("hufenc", "hufenc.ops", "encode_pack_plain", "encode_pack_cuda"),
        ("gather_pack", "hufenc.ops", "encode_pack_plain",
         "gather_pack_cuda"),
        ("hufenc_flat", "hufenc.ops", "hufenc_plain", "hufenc_cuda"),
        ("histogram", "histogram.ops", "histogram_plain", "histogram_cuda"),
        ("ceaz_chunk_dec", "megakernel.ops", "ceaz_chunk_dec_plain",
         "ceaz_chunk_dec_cuda"),
        ("hufdec", "hufdec.ops", "hufdec_plain", "hufdec_cuda"),
        ("ceaz_chunk", "megakernel.ops", "ceaz_chunk_plain",
         "ceaz_chunk_cuda"),
        ("lorenzo_quant", "megakernel.ops", "lorenzo_quant_plain",
         "lorenzo_quant_cuda"),
        ("value_quant", "megakernel.ops", "value_quant_plain",
         "value_quant_cuda"),
        ("value_finalize", "megakernel.ops", "value_finalize_plain",
         "value_finalize_cuda"),
        ("bank_select", "megakernel.ops", "bank_select_plain",
         "bank_select_cuda"),
        ("dq_center", "dualquant.ops", "chunk_center_plain",
         "dq_center_cuda"),
        *((op, "bitpack.ops", op + "_plain", op + "_cuda")
          for op in ("pack", "unpack", "pack_flat", "unpack_flat",
                     "pack_words", "unpack_words"))):
    register(_op, "torch", _loader(_module, _plain))
    register(_op, "cuda", _loader(_module, _cuda))
