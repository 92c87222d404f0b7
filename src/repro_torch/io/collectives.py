"""Compressed collectives: the paper's MPI_Gather scenario.

The port of ``src/repro/io/collectives.py``. ``compressed_all_gather``
moves fixed-ratio payloads instead of raw floats: per rank, an optional
1-D Lorenzo residual stream, one scale max|r| / (2^(b-1) - 1) + 1e-30,
b-bit codes packed MSB-first into u32 words (the bitpack op, consecutive
layout: csrc/bitpack.cu on the card); then the words and scales are
gathered, unpacked, dequantized and, for Lorenzo, prefix-summed back.
Static sizes throughout: wire bytes are b/32 of the f32 payload plus one
scale a rank.

The reference runs it under ``shard_map`` over a mesh axis. Here the rank
axis is a ``torch.distributed`` group, or the leading axis of ``x`` when
no group is given (one card runs every rank's encode and decode, batched
over that axis). Words and scales are the reference's bits in both forms;
non-Lorenzo values too. The Lorenzo decode is an f32 prefix sum whose
association differs from XLA's ``cumsum``, so it is held to the scan's
error bound, not bitwise. The port's scan is blocked in two levels
(:func:`blocked_cumsum`), so that bound depends on the block sizes and not
on the order ``torch.cumsum`` sums in on the card or on the CPU.

``ceaz_gather`` is the same scenario through the Huffman codec: every
rank's shard through the facade's ``compress_batch`` (one batched pass
pair for same-shape f32 ranks), the payloads gathered with raw and wire
byte counts; ``ceaz_gather_decode`` decodes them in one batched pass.
``ceaz_gather_stream`` commits the ranks' payloads to one ``.ceazs``
stream through the async engine, and ``read_gather_stream`` reads it
back. Their streams are the reference's bit for bit.

``DeadlineGather`` is the host-level straggler-tolerant gather (bounded
staleness), unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..kernels.bitpack import ops as BP
from ..optim.adamw import sqrt_block
from ..optim.grad_compress import (dequantize_rows, gather_ranks,
                                   quantize_rows)
from ..runtime.fused import target_device


@dataclasses.dataclass(frozen=True)
class WireFormat:
    bits: int = 8
    use_lorenzo: bool = True     # 1-D Lorenzo residuals before quantizing


def _encode_local(x2: torch.Tensor, bits: int, use_lorenzo: bool):
    """x2 (R, n) f32, one rank a row -> (packed (R * ceil(n/per),) int32
    words, rank r's in the r-th block; scales (R,) f32)."""
    if use_lorenzo:
        # prediction residual stream; the first value's predictor is x0*0,
        # as the reference writes it (NaN/Inf propagate the same way)
        shifted = torch.cat([x2[:, :1] * 0, x2[:, :-1]], dim=1)
        resid = x2 - shifted
    else:
        resid = x2
    q, scale = quantize_rows(resid, bits)
    per = 32 // bits
    n = x2.shape[1]
    pad = (-n) % per                 # each rank's words start a new word
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    return BP.pack_words(q, bits), scale


def _decode_local(packed: torch.Tensor, scales: torch.Tensor, n: int,
                  bits: int, use_lorenzo: bool) -> torch.Tensor:
    """packed words of R ranks (R blocks of ceil(n/per)), scales (R,)
    -> (R, n) f32."""
    R = scales.shape[0]
    npad = -(-n // (32 // bits)) * (32 // bits)
    q = BP.unpack_words(packed, R * npad, bits).reshape(R, npad)[:, :n]
    resid = dequantize_rows(q, scales, bits)
    if use_lorenzo:
        return blocked_cumsum(resid, sqrt_block(n))
    return resid


def blocked_cumsum(r2: torch.Tensor, block: int) -> torch.Tensor:
    """Prefix sums of each row of r2 (R, n) f32, in two levels: the f32
    cumsum inside each block of ``block`` values, the f32 cumsum of the
    block totals, then one add of the carry into the block. Every output
    is an f32 sum whose terms each take at most block + n/block roundings,
    whatever order ``torch.cumsum`` uses inside a level
    (:func:`lorenzo_bounds`)."""
    R, n = r2.shape
    nb = -(-n // block)
    local = torch.nn.functional.pad(r2, (0, nb * block - n)).reshape(
        R, nb, block).cumsum(dim=2)
    carry = torch.cumsum(local[:, :-1, -1], dim=1)      # totals before b
    local[:, 1:] += carry[:, :, None]
    return local.reshape(R, nb * block)[:, :n]


def compressed_all_gather(x, wire: WireFormat = WireFormat(), group=None,
                          device="cuda") -> torch.Tensor:
    """Gather every rank's shard through the fixed-width wire format.

    With a group, ``x`` is this process's shard (*shard); with
    ``group=None``, ``x`` is (R, *shard), rank r in row r. Either way the
    result is (R, *shard): every rank's decoded shard, what each rank of
    the reference holds after the gather. Runs on ``device`` (the card
    unless ``device='cpu'``; a gloo group takes CPU tensors)."""
    dev = target_device(device)
    x = torch.as_tensor(x).to(dev, torch.float32)
    shard = x.shape if group is not None else x.shape[1:]
    x2 = x.reshape(-1, int(np.prod(shard, dtype=np.int64)))
    packed, scales = _encode_local(x2, wire.bits, wire.use_lorenzo)
    if group is not None:
        packed = gather_ranks(packed, group).reshape(-1)
        scales = gather_ranks(scales, group).reshape(-1)
    dec = _decode_local(packed, scales, x2.shape[1], wire.bits,
                        wire.use_lorenzo)
    return dec.reshape((-1,) + tuple(shard))


def wire_bytes(n_ranks: int, shard_values: int, bits: int) -> int:
    """Bytes the gather moves: each rank's packed words and its scale."""
    return n_ranks * (4 * BP.words_len(shard_values, bits) + 4)


def step_bound(scale: float, max_abs: float) -> float:
    """Bound on |r - r^| for one value of a row quantized at `scale` whose
    largest magnitude is `max_abs`: q = rint(fl(r/scale)) is within 1/2 +
    u|r|/scale of r/scale and the product q*scale rounds by u|r^| (u =
    2^-24); the two u terms together stay under 2^-23 * max_abs (where
    |r| is within scale/4 of max_abs, rint's own error is under 1/4)."""
    return 0.5 * float(scale) + 2.0 ** -23 * float(max_abs)


def lorenzo_bounds(x: np.ndarray, resid_hat: np.ndarray, scale: float,
                   block: Optional[int] = None):
    """Float64 bounds for one rank's Lorenzo decode dec = f32 scan of the
    dequantised residuals r^ -> (S, scan, open_loop), each (n,), with
    A_i = sum_{j<=i} |r^_j| and g(d) = (1 + u)^d - 1 (u = 2^-24) the
    relative error of a term that takes d roundings:

      * S: the prefix sums of r^ in float64 (within i * 2^-53 * A_i);
      * |dec_i - S_i| <= scan_i. For the port's :func:`blocked_cumsum`
        (``block`` given), with i = b * block + t: a term of an earlier
        block takes at most block - 1 roundings in its block's total,
        b - 1 in the carry's cumsum and 1 in the carry's add, a term of
        block b at most t, plus that add; so scan_i = g(block + b - 1) *
        A_{b*block - 1} + g(t + 1) * (A_i - A_{b*block - 1}), whatever the
        order inside each cumsum. For a scan of unknown structure (XLA's,
        ``block=None``) a term of an f32 sum of i + 1 terms takes at most
        i roundings: scan_i = g(i) * A_i;
      * |x_i - dec_i| <= open_loop_i = (i+1) * step_bound + u * sum_{j<=i}
        |r_j| + scan_i, with r_j = fl(x_j - x_{j-1}) the residual quantized
        (each within step_bound of r^_j) and u|r_j| its subtraction error.
    """
    u = 2.0 ** -24
    x = np.asarray(x, np.float32).reshape(-1)
    r = np.diff(x, prepend=np.float32(0)).astype(np.float64)
    rh = np.asarray(resid_hat, np.float64).reshape(-1)
    A = np.cumsum(np.abs(rh))
    i = np.arange(x.size, dtype=np.float64)
    g = lambda d: np.expm1(d * np.log1p(u))
    if block is None:
        scan = g(i) * A
    else:
        b, t = np.divmod(np.arange(x.size), block)
        before = np.where(b > 0, A[np.maximum(b * block - 1, 0)], 0.0)
        scan = g(block + b - 1.0) * before + g(t + 1.0) * (A - before)
    scan = scan + (i + 1) * 2.0 ** -53 * A
    open_loop = ((i + 1) * step_bound(scale, np.abs(r).max(initial=0))
                 + u * np.cumsum(np.abs(r)) + scan)
    return np.cumsum(rh), scan, open_loop


def _gather_comp(eb_rel: float, chunk_values: int, block_size: int,
                 device):
    from ..core import CEAZ, CEAZConfig
    return CEAZ(CEAZConfig(mode="rel", eb=eb_rel, use_fused=True,
                           chunk_bytes=4 * chunk_values,
                           block_size=block_size, device=device))


def ceaz_gather(shards, eb_rel: float = 1e-4, plan=None,
                chunk_values: int = 1 << 20, block_size: int = 4096,
                device="cuda"):
    """Host-level compressed gather: the paper's MPI_Gather scenario
    through the Huffman codec.

    Every rank's shard is compressed by the facade's ``compress_batch``
    on `device` (the card unless the caller asks for the CPU): same-shape
    f32 ranks share ONE batched pass pair, ragged or float64 ranks take
    per-rank passes. A `plan` whose mesh spans one device runs the pass
    there. Only the packed payloads are 'gathered'. Returns
    (compressed_list, stats), stats giving raw vs wire bytes (the
    paper's Fig 17 quantity): ``raw_bytes``, ``wire_bytes``, ``ratio``,
    ``n_ranks``.
    """
    shards = [np.asarray(s) for s in shards]
    comp = _gather_comp(eb_rel, chunk_values, block_size, device)
    comps = comp.compress_batch(shards, plan=plan)
    raw = sum(int(s.nbytes) for s in shards)
    wire = sum(c.nbytes() for c in comps)
    return comps, dict(raw_bytes=raw, wire_bytes=wire,
                       ratio=raw / max(wire, 1), n_ranks=len(comps))


def ceaz_gather_decode(comps, block_size: int = 4096, device="cuda"):
    """Aggregator-side inverse of :func:`ceaz_gather`: every rank's
    shard, in rank order, from ONE batched decode pass of the facade on
    `device` (``CEAZ.decompress_batch``)."""
    from ..core import CEAZ, CEAZConfig
    comp = CEAZ(CEAZConfig(mode="rel", use_fused=True,
                           block_size=block_size, device=device))
    return comp.decompress_batch(comps)


def read_gather_stream(path: str, block_size: Optional[int] = None,
                       group: int = 4, device="cuda"):
    """Read an aggregated gather stream back to per-rank arrays.

    The engine's prefetch thread reads and deserializes rank records
    while groups of `group` decode as one batched pass each on `device`.
    The decode grain comes from the stream's footer meta unless
    `block_size` is given (a mismatch with the stream raises rather than
    decoding garbage). Returns (arrays, the read engine's stats dict).
    """
    from ..core import CEAZ, CEAZConfig
    from . import engine as E
    comp = (CEAZ(CEAZConfig(mode="rel", use_fused=True,
                            block_size=block_size, device=device))
            if block_size is not None else None)
    with E.AsyncDecodeReadEngine(path, comp, group=group,
                                 device=device) as eng:
        arrays = [obj for _, obj in eng]
    return arrays, eng.stats.as_dict()


def ceaz_gather_stream(shards, path: str, eb_rel: float = 1e-4,
                       plan=None, chunk_values: int = 1 << 20,
                       block_size: int = 4096, group: int = 2,
                       overlap: bool = True, device="cuda"):
    """Streaming gather: rank shards land in one indexed stream file.

    As each group of `group` rank shards finishes its batched pass on
    `device`, its payloads commit to the stream while the next group
    compresses (two-phase aggregation, the phases overlapped;
    ``overlap=False`` runs them inline and writes the same records).
    `shards` may hold callables: a rank arrives when its fetcher is
    called. Records are ``rank_0000``, ``rank_0001``, ...; the footer
    meta is ``{"kind": "gather", "eb_rel": ...}`` with the block grain.
    Returns gather stats: raw and wire bytes, ratio, ranks, the engine's
    wall seconds and overlap efficiency, and `path`.
    """
    from . import engine as E
    comp = _gather_comp(eb_rel, chunk_values, block_size, device)
    eng = E.AsyncCompressWriteEngine(
        path, E.ceaz_compress_fn(comp, plan),
        sync=not overlap, meta={"kind": "gather", "eb_rel": eb_rel},
        block_size=block_size)
    with eng:
        shards = list(shards)
        for s in range(0, len(shards), max(1, group)):
            grp = [np.asarray(sh() if callable(sh) else sh)
                   for sh in shards[s:s + max(1, group)]]
            eng.submit_batch(
                [f"rank_{s + j:04d}" for j in range(len(grp))], grp,
                [{"shape": list(a.shape), "dtype": str(a.dtype),
                  "raw_nbytes": int(a.nbytes)} for a in grp])
    d = eng.stats.as_dict()
    return dict(raw_bytes=d["raw_bytes"], wire_bytes=d["stored_bytes"],
                ratio=d["raw_bytes"] / max(d["stored_bytes"], 1),
                n_ranks=d["n_records"], wall_s=d["wall_s"],
                overlap_efficiency=d["overlap_efficiency"], path=path)


@dataclasses.dataclass
class DeadlineGather:
    """Host-side straggler-tolerant gather (bounded staleness)."""
    deadline_s: float
    last_good: Optional[List[np.ndarray]] = None
    stats: dict = dataclasses.field(
        default_factory=lambda: {"rounds": 0, "dropped": 0})

    def gather(self, fetchers: List[Callable[[], np.ndarray]]):
        """fetchers: one callable per rank returning its (possibly slow)
        shard. Ranks exceeding the per-round deadline are backfilled."""
        out: List[Optional[np.ndarray]] = []
        t0 = time.perf_counter()
        dropped = 0
        for i, fetch in enumerate(fetchers):
            remaining = self.deadline_s - (time.perf_counter() - t0)
            if remaining <= 0 and self.last_good is not None:
                out.append(self.last_good[i])
                dropped += 1
                continue
            out.append(fetch())
        if self.last_good is None:
            self.last_good = list(out)
        else:
            self.last_good = [o if o is not None else lg
                              for o, lg in zip(out, self.last_good)]
        self.stats["rounds"] += 1
        self.stats["dropped"] += dropped
        return out, dropped
