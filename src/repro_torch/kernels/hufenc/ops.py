"""The Huffman pack ops: pass 2's gather-pack of chunk rows, and the
staged route's device encoder of one chunk.

    hufenc(codes2, valid2, lengths_tbl, cwords_tbl, block_size, w32)
      -> (words (C, w32) int32 holding u32 bits, block_nbits (C, nblocks))
    gather_pack(...)             the same call and output
    hufenc_flat(codes, lengths, cwords, block_size, total_bits)
      -> (words (2*(nwords+1),) int32 holding u32 bits, nbits (nblocks,))

`hufenc` and `gather_pack`: codes2 (C, cv) int32 symbols, valid2 (C, cv)
bool, one codebook row per chunk: lengths_tbl / cwords_tbl (C, 1024)
int32. The payload is the contiguous MSB-first bitstream of the
reference's ``hufenc`` op (``src/repro/kernels/hufenc/ref.py::
encode_pack``), cut at u32 grain and truncated at w32 words;
block_nbits counts valid symbols' bits. `hufenc` is the port of the
word-tiled TPU kernel (the fused route's pass 2), `gather_pack` of the
one-program-per-chunk one (the staged route's packer); both compute the
same function, so on the card both are one kernel, counted under the
TPU kernel each replaces: one launch of persistent CTAs taking
4096-symbol tiles of the rows by ticket, each tile's first bit found by
a decoupled look-back.

`hufenc_flat` packs a flat stream of n symbols against one codebook
(lengths, cwords (1024,) int32) into the u32 halves of the host stream
``core/huffman.py::encode`` returns (``nwords+1`` u64 words, the last
one zero; total_bits is the stream's bit count), with each stream
block's bit count: the TPU kernel ``hufenc`` (one padded row a block)
followed by the reference's host ``hufenc/ops.py::to_host_stream``. The
tail block holds only the real symbols.

  * plain PyTorch: :func:`encode_pack_plain` (`hufenc`, `gather_pack`):
    each symbol's shifted codeword halves are summed into their words
    with ``index_add_`` (bits of distinct symbols are disjoint, so the
    sum is the OR); u32 words ride in int64 because CPU ``torch.uint32``
    has no shifts. :func:`hufenc_plain` (`hufenc_flat`) is the two steps
    of the reference: :func:`hufenc_blocks_plain` (its plain version on
    the (nblocks, block_size) reshape, a row of :func:`row_words` words a
    block) and :func:`stitch_plain` (a torch port of ``to_host_stream``).
  * CUDA: the kernels of csrc/hufenc.cu (`hufenc` and `gather_pack`:
    ``gather_pack_kernel``; `hufenc_flat`: ``hufenc_kernel``, counted
    under ``hufenc``, the TPU kernel it replaces).

:func:`encode_device` is the counterpart of ``huffman.encode`` on the
card for one chunk: it packs with `gather_pack` or with `hufenc_flat`,
by chunk size.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from .. import dispatch

NUM_SYMBOLS = 1024
_M32 = 0xFFFFFFFF
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_GATHER_ARGS = [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P, _P, _P,
                _I64, _P]
_HUFENC_ARGS = [_P, _I64, _P, _P, _I64, _I64, _P, _P, _P, _I64, _P]

# Chunks of at most this many values pack with `gather_pack` (the
# multi-row pack, which reads a valid flag beside each code), larger ones
# with `hufenc_flat` (one book, no flags, the next tile prefetched into
# the L2) — the small-chunk / large-chunk split that the reference's
# hufenc/kernel.py:86-92 draws between its kernels. Both give the same
# bits. On the H100 this is a speed rule: `hufenc_flat` is the faster op
# at every size chip_smoke.py measures on T.E's codes, 2^15 to 2^23
# (L2-cold device ms, PERF.md section 6). The crossover lies at or below
# 2^15, and nothing below 2^15 was measured; the line sits at that
# smallest size measured, so the reference's section 4.7 chunks of 2^15
# values keep `gather_pack` on the staged route.
GATHER_PACK_MAX_VALUES = 1 << 15


def _nblocks(cv: int, block_size: int) -> int:
    return max(1, -(-cv // block_size))


@functools.lru_cache(maxsize=256)
def gather_pack_scratch_bytes(C: int, cv: int) -> int:
    """Bytes of the look-back scratch of a `gather_pack` launch over C
    rows of cv symbols, from the built kernel library (csrc/hufenc.cu
    owns its layout)."""
    fn = _build.function("ceaz_gather_pack_scratch_bytes", [_I64, _I64])
    fn.restype = _I64
    return fn(C, cv)


def gather_pack_plan(C: int, nblocks: int, w32: int, scratch_bytes: int):
    """The one buffer of a `gather_pack` launch, which the C entry
    zeroes: (its size in int64 words, and the int64-word offsets of
    block_nbits and of the kernel's scratch in it).

    The buffer holds, in order: words (C*w32 int32) and block_nbits
    (C*nblocks int32), each from an int64 boundary, then the scratch of
    scratch_bytes bytes."""
    at_nbits = -(-C * w32 // 2)
    at_scratch = at_nbits + -(-C * nblocks // 2)
    return at_scratch + -(-scratch_bytes // 8), at_nbits, at_scratch


def encode_pack_plain(codes2: torch.Tensor, valid2: torch.Tensor,
                      lengths_tbl: torch.Tensor, cwords_tbl: torch.Tensor,
                      block_size: int, w32: int):
    C, cv = codes2.shape
    dev = codes2.device
    codes = codes2.to(torch.int64).clamp(0, NUM_SYMBOLS - 1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    lens = torch.where(valid2, torch.gather(lengths_tbl.to(torch.int64), 1,
                                            codes), zero)
    vals = torch.where(valid2, torch.gather(
        cwords_tbl.to(torch.int64) & _M32, 1, codes), zero)
    nblocks = _nblocks(cv, block_size)
    lens_p = torch.nn.functional.pad(lens, (0, nblocks * block_size - cv))
    block_nbits = lens_p.reshape(C, nblocks, block_size).sum(2)

    ends = torch.cumsum(lens, 1)
    starts = ends - lens
    word = starts >> 5
    left = 32 - (starts & 31) - lens                 # < 0: spills a word
    hi = torch.where(left >= 0, (vals << left.clamp(0, 31)) & _M32,
                     vals >> (-left).clamp(0, 31))
    lo = torch.where(left < 0, (vals << (32 + left).clamp(0, 31)) & _M32,
                     zero)
    row = torch.arange(C, device=dev)[:, None] * w32
    words = torch.zeros(C * w32, dtype=torch.int64, device=dev)
    live = lens > 0
    for part, w in ((hi, word), (lo, word + 1)):
        keep = live & (w < w32)
        words.index_add_(0, (row + w)[keep], part[keep])
    return (words.reshape(C, w32).to(torch.int32),
            block_nbits.to(torch.int32))


def _check_pack_args(name, codes2, valid2, lengths_tbl, cwords_tbl):
    dispatch.require_cuda(name, codes2, valid2, lengths_tbl, cwords_tbl)
    for arg, t, dt in (("codes2", codes2, torch.int32),
                       ("valid2", valid2, torch.bool),
                       ("lengths_tbl", lengths_tbl, torch.int32),
                       ("cwords_tbl", cwords_tbl, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"{name}: {arg} must be {dt}, got {t.dtype}")
    C = codes2.shape[0]
    if valid2.shape != codes2.shape or lengths_tbl.shape != (C, NUM_SYMBOLS) \
            or cwords_tbl.shape != (C, NUM_SYMBOLS):
        raise ValueError(f"{name}: codes2/valid2 (C, cv) and codebook "
                         f"tables (C, {NUM_SYMBOLS}) expected")


def _pack_cuda(name: str, codes2: torch.Tensor, valid2: torch.Tensor,
               lengths_tbl: torch.Tensor, cwords_tbl: torch.Tensor,
               block_size: int, w32: int):
    """csrc/hufenc.cu ``ceaz_gather_pack``, counted under `name`: one
    launch of persistent CTAs taking 4096-symbol tiles by ticket, the
    tiles' bit offsets by decoupled look-back. words, block_nbits and the
    kernel's scratch share one allocation (gather_pack_plan), zeroed by
    one memset in the C entry."""
    _check_pack_args(name, codes2, valid2, lengths_tbl, cwords_tbl)
    C, cv = codes2.shape
    dev = codes2.device
    nblocks = _nblocks(cv, block_size)
    if C == 0 or cv == 0:
        return (torch.zeros((C, w32), dtype=torch.int32, device=dev),
                torch.zeros((C, nblocks), dtype=torch.int32, device=dev))
    size, at_nbits, at_scratch = gather_pack_plan(
        C, nblocks, w32, gather_pack_scratch_bytes(C, cv))
    buf = torch.empty(2 * size, dtype=torch.int32, device=dev)
    words = buf.as_strided((C, w32), (w32, 1))
    block_nbits = buf.as_strided((C, nblocks), (nblocks, 1), 2 * at_nbits)
    at = buf.data_ptr()
    dispatch.count_launch(name)
    rc = _build.function("ceaz_gather_pack", _GATHER_ARGS)(
        codes2.data_ptr(), valid2.data_ptr(), lengths_tbl.data_ptr(),
        cwords_tbl.data_ptr(), C, cv, block_size, nblocks, w32, at,
        at + 8 * at_nbits, at + 8 * at_scratch, 8 * size,
        dispatch.stream_handle())
    _build.check(rc, name)
    return words, block_nbits


def encode_pack_cuda(codes2: torch.Tensor, valid2: torch.Tensor,
                     lengths_tbl: torch.Tensor, cwords_tbl: torch.Tensor,
                     block_size: int, w32: int):
    """The `hufenc` op on the card (the fused route's pass 2, and the bank
    encode's pack): the one-launch pack, counted as the word-tiled TPU
    kernel it replaces."""
    return _pack_cuda("gather_pack_tiled", codes2, valid2, lengths_tbl,
                      cwords_tbl, block_size, w32)


def gather_pack_cuda(codes2: torch.Tensor, valid2: torch.Tensor,
                     lengths_tbl: torch.Tensor, cwords_tbl: torch.Tensor,
                     block_size: int, w32: int):
    """The `gather_pack` op on the card (the staged route's packer of one
    chunk): the same one-launch pack, counted as the one-program-per-chunk
    TPU kernel it replaces."""
    return _pack_cuda("gather_pack", codes2, valid2, lengths_tbl,
                      cwords_tbl, block_size, w32)


def row_words(block_size: int, max_len: int) -> int:
    """u32 words of one :func:`hufenc_blocks_plain` row: a full block at
    the codebook's length limit, plus one."""
    return -(-block_size * max_len // 32) + 1


def hufenc_blocks_plain(codes: torch.Tensor, lengths: torch.Tensor,
                        cwords: torch.Tensor, block_size: int, max_len: int):
    """Plain PyTorch version: the `hufenc` op's plain version on the
    (nblocks, block_size) reshape, the tail block's padding invalid."""
    n = codes.numel()
    nblocks = _nblocks(n, block_size)
    pad = nblocks * block_size - n
    codes2 = torch.nn.functional.pad(codes.reshape(-1), (0, pad)) \
        .reshape(nblocks, block_size)
    valid2 = (torch.arange(nblocks * block_size, device=codes.device) < n) \
        .reshape(nblocks, block_size)
    rows, nbits = encode_pack_plain(
        codes2, valid2, lengths.reshape(1, -1).expand(nblocks, -1),
        cwords.reshape(1, -1).expand(nblocks, -1), block_size,
        row_words(block_size, max_len))
    return rows, nbits[:, 0]


def _stream_words32(total_bits: int) -> int:
    """u32 words of the host stream: ``huffman.encode``'s nwords+1 u64."""
    return 2 * ((total_bits + 63) // 64 + 1)


def stitch_plain(rows: torch.Tensor, nbits: torch.Tensor, total_bits: int):
    """Plain PyTorch version, a port of ``to_host_stream``: expand each
    row's valid bits, concatenate them, pack MSB-first."""
    nblocks, R = rows.shape
    dev = rows.device
    shifts = 31 - torch.arange(32, device=dev)
    bits = (((rows.to(torch.int64) & _M32)[..., None] >> shifts) & 1) \
        .to(torch.uint8).reshape(nblocks, R * 32)
    keep = torch.arange(R * 32, device=dev)[None, :] \
        < nbits.to(torch.int64)[:, None]
    allbits = bits[keep]
    n32 = _stream_words32(total_bits)
    allbits = torch.nn.functional.pad(allbits, (0, 32 * n32 - allbits.numel()))
    words = (allbits.reshape(n32, 32).to(torch.int64) << shifts).sum(1)
    return words.to(torch.int32)


def hufenc_plain(codes: torch.Tensor, lengths: torch.Tensor,
                 cwords: torch.Tensor, block_size: int, total_bits: int):
    """Plain PyTorch version of `hufenc_flat`: the blocks' rows
    (:func:`hufenc_blocks_plain`, wide enough for a block at the book's
    longest code), then their stitch (:func:`stitch_plain`)."""
    max_len = max(1, int(lengths.max())) if lengths.numel() else 1
    rows, nbits = hufenc_blocks_plain(codes, lengths, cwords, block_size,
                                      max_len)
    return stitch_plain(rows, nbits, total_bits), nbits


def hufenc_cuda(codes: torch.Tensor, lengths: torch.Tensor,
                cwords: torch.Tensor, block_size: int, total_bits: int):
    """csrc/hufenc.cu ``ceaz_hufenc``: one launch of ``hufenc_kernel``
    (persistent CTAs taking 4096-symbol tiles by ticket, each CTA's next
    tile prefetched into the L2 by a TMA bulk prefetch, each tile's first
    bit by decoupled look-back), counted under ``hufenc``. The stream's words, the blocks' bit counts
    and the kernel's scratch share one allocation (gather_pack_plan),
    zeroed by one memset in the C entry. Bits past the stream's
    ``2*(nwords+1)`` words are dropped."""
    dispatch.require_cuda("hufenc", codes, lengths, cwords)
    if codes.dtype != torch.int32 or codes.ndim != 1 \
            or lengths.dtype != torch.int32 or cwords.dtype != torch.int32 \
            or lengths.shape != (NUM_SYMBOLS,) \
            or cwords.shape != (NUM_SYMBOLS,):
        raise ValueError("hufenc: codes (n,) int32 and codebook tables "
                         f"({NUM_SYMBOLS},) int32 expected")
    if block_size < 1 or total_bits < 0:
        raise ValueError(f"hufenc: block_size >= 1 and total_bits >= 0 "
                         f"expected, got {block_size}, {total_bits}")
    n = codes.numel()
    dev = codes.device
    nblocks = _nblocks(n, block_size)
    n32 = _stream_words32(total_bits)
    if n == 0:
        return (torch.zeros(n32, dtype=torch.int32, device=dev),
                torch.zeros(nblocks, dtype=torch.int32, device=dev))
    size, at_nbits, at_scratch = gather_pack_plan(
        1, nblocks, n32, gather_pack_scratch_bytes(1, n))
    buf = torch.empty(2 * size, dtype=torch.int32, device=dev)
    at = buf.data_ptr()
    dispatch.count_launch("hufenc")
    rc = _build.function("ceaz_hufenc", _HUFENC_ARGS)(
        codes.data_ptr(), n, lengths.data_ptr(), cwords.data_ptr(),
        block_size, n32, at, at + 8 * at_nbits, at + 8 * at_scratch,
        8 * size, dispatch.stream_handle())
    _build.check(rc, "hufenc")
    return (buf[:n32], buf[2 * at_nbits:2 * at_nbits + nblocks])


def u32_to_u64(u32: np.ndarray) -> np.ndarray:
    """Fold MSB-first u32 pairs into the u64 wire words."""
    return ((u32[0::2].astype(np.uint64) << np.uint64(32))
            | u32[1::2].astype(np.uint64))


def encode_device(codes: torch.Tensor, cb, block_size: int, freqs=None,
                  kernel_impl: str = "auto"):
    """``core/huffman.py::encode`` for one chunk of symbols on their
    device: the same (words u64, block_nbits int64, total_bits), bit for
    bit.

    codes: (n,) int32 symbols; cb: a Codebook; freqs: the chunk's
    1024-bin histogram when the caller has it (else the `histogram` op
    counts it). Chunks of at most GATHER_PACK_MAX_VALUES values pack
    through `gather_pack`, larger ones through `hufenc_flat`.

    Raises ValueError when a present symbol has no code, as ``encode``
    does; the check runs on the host from the histogram, before any pack.
    """
    dev = codes.device
    codes = codes.reshape(-1)
    n = codes.numel()
    if freqs is None:
        hist = dispatch.resolve("histogram", kernel_impl, dev)
        with dispatch.measure("histogram", kernel_impl, dev):
            freqs = hist(codes.reshape(1, n), dispatch.all_valid(n, dev))
        freqs = freqs[0].cpu().numpy()
    lengths = np.asarray(cb.lengths).astype(np.int64)
    freqs = np.asarray(freqs).astype(np.int64)
    if np.any((freqs > 0) & (lengths == 0)):
        raise ValueError("codebook does not cover all present symbols")
    total = int(freqs @ lengths)
    # both tables in one host-to-device copy
    tables = torch.from_numpy(np.stack([
        lengths.astype(np.int32),
        np.asarray(cb.codes).astype(np.uint32).view(np.int32)])).to(dev)
    if n <= GATHER_PACK_MAX_VALUES:
        pack = dispatch.resolve("gather_pack", kernel_impl, dev)
        with dispatch.measure("gather_pack", kernel_impl, dev):
            words, nbits = pack(
                codes.reshape(1, n), dispatch.all_valid(n, dev),
                tables[0:1], tables[1:2], block_size, _stream_words32(total))
        words, nbits = words[0], nbits[0]
    else:
        pack = dispatch.resolve("hufenc_flat", kernel_impl, dev)
        with dispatch.measure("hufenc_flat", kernel_impl, dev):
            words, nbits = pack(codes, tables[0], tables[1], block_size,
                                total)
    return (u32_to_u64(words.cpu().numpy().view(np.uint32)),
            nbits.cpu().numpy().astype(np.int64), total)
