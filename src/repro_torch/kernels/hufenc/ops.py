"""The Huffman pack ops: pass 2's gather-pack of chunk rows, and the
staged route's device encoder of one chunk.

    hufenc(codes2, valid2, lengths_tbl, cwords_tbl, block_size, w32)
      -> (words (C, w32) int32 holding u32 bits, block_nbits (C, nblocks))
    gather_pack(...)             the same call and output
    hufenc_blocks(codes, lengths, cwords, block_size, max_len)
      -> (rows (nblocks, R) int32 holding u32 bits, nbits (nblocks,) int32)
    hufenc_stitch(rows, nbits, total_bits) -> words (2*(nwords+1),) int32

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

`hufenc_blocks` packs a flat stream of n symbols against one codebook,
one row of ``R = ceil(block_size*max_len/32) + 1`` words per stream
block (the TPU kernel ``hufenc``'s layout, sized from the codebook's
length limit instead of a fixed 16 bits and 4096 symbols); the tail
block holds only the real symbols. `hufenc_stitch` lays the rows end to
end at their exclusive-cumsum bit offsets into the u32 halves of the
host stream ``core/huffman.py::encode`` returns (``nwords+1`` u64
words, the last one zero).

  * plain PyTorch: :func:`encode_pack_plain` (`hufenc`, `gather_pack`,
    and `hufenc_blocks` on the (nblocks, block_size) reshape with
    w32=R): each symbol's shifted codeword halves are summed into their
    words with ``index_add_`` (bits of distinct symbols are disjoint, so
    the sum is the OR); u32 words ride in int64 because CPU
    ``torch.uint32`` has no shifts. :func:`stitch_plain` is a torch port
    of the reference's ``hufenc/ops.py::to_host_stream``.
  * CUDA: the kernels of csrc/hufenc.cu (`hufenc` and `gather_pack`:
    ``gather_pack_kernel``; `hufenc_blocks`: ``blocks_pack_kernel``;
    `hufenc_stitch`: ``stitch_kernel``).

:func:`encode_device` is the counterpart of ``huffman.encode`` on the
card for one chunk: it packs with `gather_pack` or with `hufenc_blocks`
+ `hufenc_stitch`, by chunk size.
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
_BLOCKS_ARGS = [_P, _I64, _P, _P, _I64, _I64, _I64, _P, _P, _P]
_STITCH_ARGS = [_P, _P, _P, _I64, _I64, _I64, _P, _P]

# Chunks of at most this many values pack in ONE `gather_pack` launch
# (a CTA a 4096-symbol tile, bit offsets by look-back); larger ones pack
# one stream block per CTA (`hufenc_blocks`, the FPGA's N pipelines) and
# are stitched — the small-chunk / large-chunk split that the
# reference's hufenc/kernel.py:86-92 draws between its kernels. Both give
# the same bits. On the H100 there is no crossover: `gather_pack` is the
# faster op at every size measured, 2^15 to 2^23 (PERF.md section 6). So
# the line is a coverage rule, not a speed rule: at 2^22 it keeps the
# per-block packer on the route of the default 32 MB chunks (T.A's
# 6.48 M values, T.E's 2^23), at the cost per chunk that PERF.md
# section 6 gives.
GATHER_PACK_MAX_VALUES = 1 << 22


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
    """u32 words of one `hufenc_blocks` row: a full block at the
    codebook's length limit, plus one."""
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


def hufenc_blocks_cuda(codes: torch.Tensor, lengths: torch.Tensor,
                       cwords: torch.Tensor, block_size: int, max_len: int):
    """csrc/hufenc.cu blocks_pack_kernel: one CTA per stream block."""
    dispatch.require_cuda("hufenc_blocks", codes, lengths, cwords)
    if codes.dtype != torch.int32 or codes.ndim != 1 \
            or lengths.dtype != torch.int32 or cwords.dtype != torch.int32 \
            or lengths.shape != (NUM_SYMBOLS,) \
            or cwords.shape != (NUM_SYMBOLS,):
        raise ValueError("hufenc_blocks: codes (n,) int32 and codebook "
                         f"tables ({NUM_SYMBOLS},) int32 expected")
    n = codes.numel()
    dev = codes.device
    nblocks = _nblocks(n, block_size)
    R = row_words(block_size, max_len)
    rows = torch.zeros((nblocks, R), dtype=torch.int32, device=dev)
    nbits = torch.zeros(nblocks, dtype=torch.int32, device=dev)
    if n == 0:
        return rows, nbits
    dispatch.count_launch("hufenc")
    rc = _build.function("ceaz_hufenc_blocks", _BLOCKS_ARGS)(
        codes.data_ptr(), n, lengths.data_ptr(), cwords.data_ptr(),
        block_size, nblocks, R, rows.data_ptr(), nbits.data_ptr(),
        dispatch.stream_handle())
    _build.check(rc, "hufenc")
    return rows, nbits


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


def stitch_cuda(rows: torch.Tensor, nbits: torch.Tensor, total_bits: int):
    """csrc/hufenc.cu stitch_kernel: each row word ORed in at its block's
    int64 bit offset (an exclusive torch cumsum of nbits)."""
    dispatch.require_cuda("hufenc_stitch", rows, nbits)
    if rows.dtype != torch.int32 or nbits.dtype != torch.int32 \
            or rows.ndim != 2 or nbits.shape != rows.shape[:1]:
        raise ValueError("hufenc_stitch: rows (nblocks, R) int32 and nbits "
                         "(nblocks,) int32 expected")
    nblocks, R = rows.shape
    n32 = _stream_words32(total_bits)
    out = torch.zeros(n32, dtype=torch.int32, device=rows.device)
    if nblocks == 0:
        return out
    first = torch.cumsum(nbits, 0, dtype=torch.int64) - nbits
    dispatch.count_launch("hufenc_stitch")
    rc = _build.function("ceaz_hufenc_stitch", _STITCH_ARGS)(
        rows.data_ptr(), nbits.data_ptr(), first.data_ptr(), nblocks, R, n32,
        out.data_ptr(), dispatch.stream_handle())
    _build.check(rc, "hufenc_stitch")
    return out


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
    through `gather_pack`, larger ones through `hufenc_blocks` and
    `hufenc_stitch`.

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
        blocks = dispatch.resolve("hufenc_blocks", kernel_impl, dev)
        stitch = dispatch.resolve("hufenc_stitch", kernel_impl, dev)
        with dispatch.measure("hufenc_blocks", kernel_impl, dev):
            rows, nbits = blocks(codes, tables[0], tables[1], block_size,
                                 int(cb.max_len))
            words = stitch(rows, nbits, total)
    return (u32_to_u64(words.cpu().numpy().view(np.uint32)),
            nbits.cpu().numpy().astype(np.int64), total)
