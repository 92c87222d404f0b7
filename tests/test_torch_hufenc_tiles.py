"""A numpy model of csrc/hufenc.cu's ``hufenc_kernel`` (the `hufenc_flat`
op on the card), held against the op's plain version and the reference.

The model follows the kernel's arithmetic step by step: 4096-symbol
tiles, over four base offsets of the stream in its 16-byte line; the
bytes of a tile's L2 prefetch (from the first 16-byte boundary of its
codes to the last, never outside them); runs of 16 symbols a thread,
every symbol before n read once, their bits and an exclusive scan for
the runs' first bits; the tile's word buffer still holding the last tile's words,
with only the runs' edge words zeroed, interior words stored and edge
words ORed, and a check that no stored word is touched by another run;
the blocks' bit counts from the scanned run starts (one
add a tile and block when the block size is a multiple of 16, else
stepped per symbol); the tiles' first bits as int64 prefixes, and the
write-out shifted to them (interior words stored, edge words ORed into
the zeroed stream, a stored word touched by no other tile). The
decoupled look-back that finds a tile's first bit is modelled over
status words whose prefixes pass 2^31.

Held against `hufenc_plain` (the blocks' rows and their stitch) and the
reference: ``core/huffman.py::encode`` (words, block bit counts, total)
at every block size, and the Pallas ``hufenc`` (interpret mode) through
``hufenc_flat`` + ``to_host_stream`` for the stream's bits (the
reference pads the tail block with a real symbol, so its stream is
compared up to the real symbols' bits)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import huffman as RH
from repro.kernels.hufenc import ops as EO
from repro_torch.kernels.hufenc import ops as TO

THREADS, PER = 256, 16
TILE = THREADS * PER
M32 = 0xFFFFFFFF
ST_AGG, ST_PRE = 1 << 62, 2 << 62
ST_VAL = ST_AGG - 1
LOOK = 2


def prefetch_range(base, t0, n_tile):
    """The words [p0, p1) of the stream a tile's L2 prefetch covers,
    for a stream whose first code is word `base` of a 16-byte-aligned
    allocation: from the tile's first 16-byte boundary to its last."""
    p0 = (base + t0 + 3) // 4 * 4
    p1 = (base + t0 + n_tile) // 4 * 4
    return p0 - base, p1 - base


def compose(run, cw, b0, bits, buf, owner, zeroed, r):
    """gp_compose + gp_emit: the run's codewords into buf from bit b0.
    owner: word -> the run that stored it, or -1 where ORed; zeroed: word
    -> the runs that zeroed it. A stored word must be touched by no other
    run: no other run's OR, store or edge zeroing lands on it."""
    b1 = b0 + bits
    bit, cur, acc, spill = b0, b0 >> 5, 0, 0

    def emit(w, v):
        if w < 0 or w >= TILE:
            return
        if 32 * w >= b0 and 32 * w + 32 <= b1:
            assert w not in owner and zeroed.get(w, {r}) == {r}
            owner[w] = r
            buf[w] = v
        elif v:
            assert owner.get(w, -1) == -1
            owner[w] = -1
            buf[w] |= v

    for code, ln in run:
        w = bit >> 5
        x = ((int(cw[code]) << (64 - (bit & 31) - ln)) & (2 ** 64 - 1)
             if ln > 0 else 0)
        bit += ln
        if w != cur:
            emit(cur, acc)
            acc, spill, cur = spill, 0, w
        acc |= (x >> 32) & M32
        spill |= x & M32
    emit(cur, acc)
    emit(cur + 1, spill)


def block_bits(pre, run, t0, i0, n, before, bs, nb):
    """gp_block_bits."""
    if i0 >= n:
        return
    p0 = t0 + i0
    if bs % PER == 0:
        blk = p0 // bs
        if i0 == 0 or p0 % bs == 0:
            end = min(n, (blk + 1) * bs - t0)
            v = pre[(end + PER - 1) // PER] - before
            if v:
                nb[blk] += v
    else:
        blk, nxt, bb = p0 // bs, (p0 // bs + 1) * bs, 0
        for i, (_, ln) in enumerate(run):
            if p0 + i == nxt:
                if bb:
                    nb[blk] += bb
                blk, nxt, bb = blk + 1, nxt + bs, 0
            bb += ln
        if bb:      # past n every length is 0: no block past the last
            nb[blk] += bb


def write_out(buf, s0, total, out, owner, tile):
    """gp_write_out into the zeroed stream of len(out) words."""
    if total <= 0:
        return
    o, w0 = s0 & 31, s0 >> 5
    nbuf, nout = (total + 31) >> 5, (o + total + 31) >> 5
    for j in range(nout):
        if w0 + j >= len(out):
            break
        hi = int(buf[j]) if j < nbuf else 0
        v = hi
        if o:
            v = (hi >> o) | (((int(buf[j - 1]) << (32 - o)) & M32)
                             if j > 0 else 0)
        if 32 * j >= o and 32 * (j + 1) <= o + total:
            assert w0 + j not in owner
            owner[w0 + j] = tile
            out[w0 + j] = v
        elif v:
            assert owner.get(w0 + j, -1) == -1
            owner[w0 + j] = -1
            out[w0 + j] |= v


def kernel_model(codes, lengths, cwords, bs, total_bits, base=0):
    """hufenc_kernel's (words u32 (2*(nwords+1),), block_nbits int64)."""
    n = len(codes)
    n32 = 2 * ((total_bits + 63) // 64 + 1)
    out = np.zeros(n32, np.uint64)
    nb = np.zeros(max(1, -(-n // bs)), np.int64)
    cw = np.asarray(cwords).astype(np.uint32)
    prefix, out_owner = 0, {}
    rng = np.random.default_rng(base)
    buf = rng.integers(0, 2 ** 32, TILE, dtype=np.uint64)   # a last tile's
    for tile in range(-(-n // TILE)):
        t0 = tile * TILE
        nt = min(TILE, n - t0)
        p0, p1 = prefetch_range(base, t0, nt)
        # whole 16-byte lines inside the tile's codes, none outside
        assert t0 <= p0 and p1 <= t0 + nt and (p1 - p0) % 4 == 0
        assert p1 <= p0 or ((base + p0) % 4 == 0 and p0 - t0 <= 3
                            and t0 + nt - p1 <= 3)
        runs, bits, read = [], [], np.zeros(nt, int)
        for tid in range(THREADS):
            i0 = tid * PER
            run = []
            for i in range(PER):
                j = i0 + i
                code, ln = 0, 0
                if j < nt:
                    read[j] += 1
                    code = min(max(int(codes[t0 + j]), 0), 1023)
                    ln = int(lengths[code])
                run.append((code, ln))
            runs.append(run)
            bits.append(sum(ln for _, ln in run))
        assert (read == 1).all()
        pre = np.concatenate([[0], np.cumsum(bits)]).astype(np.int64)
        total = int(pre[-1])
        # the buffer holds the last tile's words; each run zeroes its two
        # edge words
        zeroed = {}
        for tid in range(THREADS):
            b0, b1 = int(pre[tid]), int(pre[tid + 1])
            if b1 > b0:
                for w in (b0 >> 5, (b1 - 1) >> 5):
                    buf[w] = 0
                    zeroed.setdefault(w, set()).add(tid)
        owner = {}
        for tid in range(THREADS):
            compose(runs[tid], cw, int(pre[tid]), bits[tid], buf, owner,
                    zeroed, tid)
        for tid in range(THREADS):
            block_bits(pre, runs[tid], t0, tid * PER, nt, int(pre[tid]), bs,
                       nb)
        write_out(buf, prefix, total, out, out_owner, tile)
        prefix += total
    assert prefix == int(np.sum(np.asarray(lengths)[np.clip(codes, 0,
                                                            1023)]))
    return out.astype(np.uint32), nb


def look_back(status, tile):
    """gp_look_back over the status words, by the whole CTA: each step
    reads THREADS * LOOK words, each warp stops at its first inclusive
    prefix, and the step's sums are taken warp by warp until one had a
    prefix."""
    excl, j = 0, tile - 1
    nw = THREADS // 32
    while j >= 0:
        part, has = [], []
        for m in range(LOOK):
            for w in range(nw):
                idx = j - THREADS * m - (32 * w + np.arange(32))
                s = [status[i] if i >= 0 else ST_PRE for i in idx]
                pre = [x >> 62 == 2 for x in s]
                stop = pre.index(True) if any(pre) else 31
                part.append(sum(x & ST_VAL for x in s[:stop + 1]))
                has.append(any(pre))
        found = False
        for p, h in zip(part, has):
            excl += p
            if h:
                found = True
                break
        if found:
            break
        j -= THREADS * LOOK
    return excl


def test_look_back_int64_prefixes():
    """Tile totals up to 4096 x 32 bits over 40000 tiles: prefixes pass
    2^31 and stay exact; published statuses mix aggregates and
    inclusive prefixes (tile 0 always an inclusive prefix)."""
    rng = np.random.default_rng(1)
    tiles = 40000
    totals = rng.integers(0, TILE * 32 + 1, tiles)
    incl = np.cumsum(totals)
    assert incl[-1] > 2 ** 31
    is_pre = rng.random(tiles) < 0.003
    is_pre[0] = True
    status = [int(ST_PRE | int(incl[i])) if is_pre[i]
              else int(ST_AGG | int(totals[i])) for i in range(tiles)]
    for tile in [0, 1, 511, 512, 513, 1025, tiles - 1,
                 *rng.integers(0, tiles, 40)]:
        assert look_back(status, int(tile)) == int(incl[tile] - totals[tile])


@functools.lru_cache(maxsize=None)
def _case(n, one_symbol):
    if one_symbol:
        codes = np.full(n, 512, np.int32)
        cb = RH.Codebook.from_freqs(np.bincount(codes, minlength=1024),
                                    smoothing=False)
        assert int(cb.lengths.sum()) == 1
    else:
        rng = np.random.default_rng(n)
        codes = np.clip(rng.normal(512, 30, n), 0, 1023).astype(np.int32)
        cb = RH.Codebook.from_freqs(np.bincount(codes, minlength=1024))
    # the reference's TPU path: the Pallas hufenc (its tail block padded
    # with symbol 512) and the host concatenation
    kw, kn, _ = EO.hufenc_flat(jnp.asarray(codes), jnp.asarray(cb.codes),
                               jnp.asarray(cb.lengths.astype(np.int32)),
                               pad_sym=512)
    stream, _ = EO.to_host_stream(kw, kn, n, cb.lengths)
    return codes, cb, stream


def _u32(u64):
    u64 = np.asarray(u64, np.uint64)
    out = np.empty(2 * len(u64), np.uint32)
    out[0::2] = (u64 >> np.uint64(32)).astype(np.uint32)
    out[1::2] = (u64 & np.uint64(M32)).astype(np.uint32)
    return out


@pytest.mark.parametrize("n", [1, 5000, 3 * TILE, 70001])
@pytest.mark.parametrize("bs", [16, 1000, 1024, 4096, 8192])
def test_model_matches_plain_and_reference(bs, n):
    """Block sizes 16 (a one-symbol book: 1-bit codes, an output word
    holds bits of several blocks), 1000 (no multiple of a run), 1024,
    4096 (the reference's) and 8192 (a block wider than a tile); n = 1, a
    ragged tail, an exact multiple of the tile and 70001; the stream at
    four base offsets in its 16-byte line."""
    codes, cb, ref_stream = _case(n, bs == 16)
    words, nbits, total = RH.encode(codes, cb, bs)
    ln = cb.lengths.astype(np.int32)
    cwords = cb.codes.astype(np.uint32)
    plain_w, plain_nb = TO.hufenc_plain(
        torch.from_numpy(codes), torch.from_numpy(ln),
        torch.from_numpy(cwords.view(np.int32)), bs, total)
    plain_w = plain_w.numpy().view(np.uint32)
    np.testing.assert_array_equal(plain_w, _u32(words))
    np.testing.assert_array_equal(plain_nb.numpy(), nbits)
    # the Pallas kernel's stream, up to the real symbols' bits
    ref = _u32(ref_stream)[:len(plain_w)]
    ref = np.pad(ref, (0, len(plain_w) - len(ref)))
    keep = np.clip(total - 32 * np.arange(len(ref)), 0, 32)
    mask = np.where(keep == 32, M32,
                    (M32 << (32 - keep)) & M32).astype(np.uint32)
    np.testing.assert_array_equal(plain_w, ref & mask)
    for base in range(4):
        mw, mnb = kernel_model(codes, ln, cwords, bs, total, base)
        np.testing.assert_array_equal(mw, plain_w)
        np.testing.assert_array_equal(mnb, nbits)


def test_model_truncates_at_the_stream_words():
    """A total_bits below the stream's bits: the kernel drops what lies
    past the 2*(nwords+1) words, as the plain version cannot be asked
    to; the model keeps the words it has."""
    codes, cb, _ = _case(5000, False)
    words, _, total = RH.encode(codes, cb, 1024)
    ln = cb.lengths.astype(np.int32)
    short = total // 3
    mw, _ = kernel_model(codes, ln, cb.codes.astype(np.uint32), 1024, short)
    full = _u32(words)
    np.testing.assert_array_equal(mw, full[:len(mw)])
