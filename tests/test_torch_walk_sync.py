"""The warp walk's rule, held against the plain walk on the CPU.

``csrc/warp_walk.cuh`` decodes a block by 64 self-synchronising segments
and keeps the result only under an exact acceptance rule; every other
block is walked by ``walk_lane``. The kernels run only on the card
(``tests/test_torch_gpu.py`` holds them bitwise against their plain
versions there), so this file models what only a model can show here:
the segments, the sync rounds and the acceptance rule, held against
``walk_plain`` on valid streams, the decode fuzz corpus's bitflips,
garbage words, tables and bit counts, and books that are hard for the
rule: 16-bit codes, one symbol, and equal-length codes that never
resynchronise. Where the rule accepts, the symbols must be the walk's;
where the fast path's symbols would differ, the rule must reject. It
also covers the 16-bit table packer and the decode pass's host checks
of its tables and segments. All outputs are integers: tolerance 0."""
import json

import numpy as np
import pytest
import torch

from test_torch_decode import CORPUS, _garbage_cases, _stage, _torch
from repro_torch.core.huffman import Codebook, _canonize, encode
from repro_torch.kernels.hufdec import ops as TH
from repro_torch.kernels.megakernel import ops as TM
from repro_torch.runtime import fused_decode as fd
from repro_torch.runtime.fused_decode import _ChunkBatch, _u64_to_u32

LANES = 32
SEGS = 2 * LANES               # segments a block: two chains a lane
MAP_AFTER = 3                  # sync rounds before the candidate maps
CANDIDATES = 16                # a segment's true start is in [lo, lo + 16)
MAP_BYTES = 4 * SEGS * (CANDIDATES + 1)   # what the staging row must hold


def _maps_fit(bs):
    return 2 * ((bs + 7) // 8 * 8) >= MAP_BYTES
KEYS = ("words2", "nbits2", "counts", "sym_flat", "len_flat", "cb_idx")


# ---------------------------------------------------------------------------
# The model (warp_walk.cuh)
# ---------------------------------------------------------------------------

def _segment(row, W, p, stop, tbl16, out=None):
    """ww_segment: decode from bit p while the cursor is below stop, with
    the kernel's reader (words w0:w1 under the cursor, two prefetched)
    -> (exit, n, stuck)."""
    word = lambda i: int(row[i]) if i < W else 0
    n, stuck = 0, False
    if p < stop:
        span = stop - p
        wi = p >> 5
        w0, w1, n1, n2 = (word(wi + k) for k in range(4))
        wi += 4
        off = p & 31
        rel = 0
        while rel < span:
            e = int(tbl16[(((w0 << 32) | w1) >> (32 - off)) >> 16 & 0xFFFF])
            ln = e >> TH.SYM_BITS
            if ln == 0:
                stuck, rel = True, span
                break
            if out is not None:
                out.append(e & (TH.NUM_SYMBOLS - 1))
            n += 1
            rel += ln
            off += ln
            if off >= 32:
                off -= 32
                w0, w1, n1, n2 = w1, n1, n2, word(wi)
                wi += 1
        p += rel
    return p, n, stuck


def _fast_block(row, W, S, N, tbl16, maps):
    """ww_decode_block without its acceptance test: 64 segments (lane j
    holds segments j and 32 + j), each restarted from its predecessor's
    exit until no start changes; past MAP_AFTER rounds, while the starts
    a round moves span 16 segments or more and where the staging row
    holds the maps,
    every segment decoded from each of its 16 candidate starts and the
    exits composed from segment 0 instead ->
    (symbols decoded from the final starts, in
    segment order; final exits; stuck; sync rounds, those before the
    maps plus 16 with them)."""
    seg = (N + SEGS - 1) // SEGS
    lo = [S + min(j * seg, N) for j in range(SEGS)]
    hi = [S + min((j + 1) * seg, N) for j in range(SEGS)]
    p, rounds = lo, 0
    while True:
        res = [_segment(row, W, p[j], hi[j], tbl16) for j in range(SEGS)]
        pn = [S] + [r[0] for r in res[:-1]]
        if pn == p:
            break
        moved = [j for j in range(SEGS) if pn[j] != p[j]]
        if maps and rounds >= MAP_AFTER and moved[-1] - moved[0] >= CANDIDATES:
            p, res = _by_maps(row, W, S, lo, hi, tbl16)
            rounds += CANDIDATES
            break
        p, rounds = pn, rounds + 1
    syms = []
    for j in range(SEGS):
        _segment(row, W, p[j], hi[j], tbl16, syms)
    return syms, [r[0] for r in res], any(r[2] for r in res), rounds


def _by_maps(row, W, S, lo, hi, tbl16):
    """Each segment from its 16 candidate starts lo + o: (exit - hi, n,
    stuck) a candidate; composed from segment 0 (offset 0) -> (starts,
    each segment's (exit, n, stuck) from its start)."""
    maps = [[_segment(row, W, lo[j] + o, hi[j], tbl16)
             for o in range(CANDIDATES)] for j in range(SEGS)]
    o, starts, res = 0, [], []
    for j in range(SEGS):
        starts.append(lo[j] + o)
        res.append(maps[j][o])
        o = maps[j][o][0] - hi[j]
        assert 0 <= o < CANDIDATES
    return starts, res


def _model_walk(arrays, bs, tb, win):
    """The walk kernel's blocks -> (codes (C, NB*bs) where each block is
    the fast path's when accepted and walk_plain's otherwise, per-block
    verdicts 'fast'/'exact'/'empty', the blocks where the unguarded fast
    path differs from the walk, most sync rounds)."""
    words = arrays["words2"].view(np.uint32)
    C, W = words.shape
    NB = arrays["nbits2"].shape[1]
    lane_start, lane_foff = TH.lane_layout(_torch(arrays["nbits2"]), tb,
                                           win, W)
    walk = TH.walk_plain(*(_torch(arrays[k]) for k in KEYS), bs, tb,
                         win).numpy().reshape(C, NB, bs)
    tbl16 = TH.packed_table16(_torch(arrays["sym_flat"]),
                              _torch(arrays["len_flat"])).numpy()
    tbl16 = tbl16.view(np.uint16).astype(np.int64)
    out = walk.copy()
    verdict, differs, max_rounds = {}, set(), 0
    cmax = (win - 2) * 32 + 31
    for c in range(C):
        t = tbl16[int(arrays["cb_idx"][c]) * TH.TBL:][:TH.TBL]
        for b in range(NB):
            cnt = int(np.clip(int(arrays["counts"][c]) - b * bs, 0, bs))
            if cnt == 0:
                verdict[c, b] = "empty"
                continue
            rel, foff = int(lane_start[c, b]), int(lane_foff[c, b])
            N = int(arrays["nbits2"][c, b])
            if not (cnt <= N <= 16 * cnt and rel >= 0
                    and rel + N - 1 <= cmax):
                verdict[c, b] = "exact"
                continue
            S = foff * 32 + rel
            syms, exits, stuck, rounds = _fast_block(words[c], W, S, N, t,
                                                     _maps_fit(bs))
            fast = np.zeros(bs, np.int32)
            fast[:min(cnt, len(syms))] = syms[:cnt]
            if not np.array_equal(fast, walk[c, b]):
                differs.add((c, b))
            if stuck or len(syms) != cnt or exits[-1] != S + N:
                verdict[c, b] = "exact"
                continue
            verdict[c, b] = "fast"
            max_rounds = max(max_rounds, rounds)
            out[c, b] = fast
    return out.reshape(C, NB * bs), verdict, differs, max_rounds


def _check_walk(arrays, bs, tiled=True, geometry=None):
    """The model of one walk against walk_plain: accepted blocks equal the
    walk, and every block where the fast path differs is rejected.
    geometry: (blocks a tile, window words), else the word-tiled walk's
    (tiled) or one tile a row."""
    W = arrays["words2"].shape[1]
    NB = arrays["nbits2"].shape[1]
    tb, win = geometry or (TH.tile_geometry(bs) if tiled else (NB, W))
    got, verdict, differs, rounds = _model_walk(arrays, bs, tb, win)
    want = TH.walk_plain(*(_torch(arrays[k]) for k in KEYS), bs, tb,
                         win).numpy()
    np.testing.assert_array_equal(got, want)
    for cb in differs:
        assert verdict[cb] == "exact", cb
    return verdict, rounds


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

def _book_arrays(rng, book, counts, bs):
    """Rows encoded with a hard book: 16-bit codes, one symbol (a one-bit
    code, the other half of the table length 0), or 1024 codes of 10
    bits (no segment guess ever resynchronises)."""
    if book == "16bit":
        f = np.maximum(1, (2.0 ** np.maximum(
            0, 40 - np.abs(np.arange(1024) - 512))).astype(np.int64))
        cb = Codebook.from_freqs(f, max_len=16)
        assert cb.lengths.max() == 16
        draw = lambda n: np.clip(rng.normal(512, 12, n), 0, 1023)
    elif book == "one_symbol":
        ln = np.zeros(1024, np.uint8)
        ln[512] = 1
        cb = Codebook(lengths=ln, codes=_canonize(ln.astype(np.int64)))
        draw = lambda n: np.full(n, 512)
    else:
        cb = Codebook.from_freqs(np.ones(1024, np.int64))
        assert set(cb.lengths.tolist()) == {10}
        draw = lambda n: rng.integers(0, 1024, n)
    rows = [encode(draw(n).astype(np.int64), cb, bs) for n in counts]
    C = len(counts)
    W = max(2 * len(r[0]) for r in rows) + 2
    NB = max(len(r[1]) for r in rows)
    words2 = np.zeros((C, W), np.uint32)
    nbits2 = np.zeros((C, NB), np.int32)
    for i, (w64, bnb, _) in enumerate(rows):
        w = _u64_to_u32(w64)
        words2[i, :len(w)] = w
        nbits2[i, :len(bnb)] = bnb
    sym, ln = cb.tables()
    return dict(words2=words2, nbits2=nbits2,
                counts=np.asarray(counts, np.int32),
                sym_flat=sym.astype(np.int32), len_flat=ln.astype(np.int32),
                cb_idx=np.zeros(C, np.int32))


@pytest.mark.parametrize("counts,bs", [([4096, 700, 37], 512),
                                       ([3000, 2999], 1000),
                                       ([1500, 20], 256)])
def test_model_accepts_every_valid_block(counts, bs):
    """Valid streams (bs a power of two and not): every block with
    symbols takes the fast path, in both window layouts, and decodes as
    the walk does."""
    rng = np.random.default_rng(sum(counts) + bs)
    arrays, _ = _stage(rng, counts, bs)
    for tiled in (True, False):
        verdict, rounds = _check_walk(arrays, bs, tiled)
        assert "exact" not in verdict.values()
        # a tail block of a few dozen bits has mostly empty segments,
        # which pass the start on one segment a round (the maps take over
        # only from blocks of ~2176 values, and only while a round moves
        # many starts)
        assert 1 <= rounds <= SEGS - 1


@pytest.mark.parametrize("bs", [500, 2500])
@pytest.mark.parametrize("book", ["16bit", "one_symbol", "equal_length"])
def test_model_on_hard_books(book, bs):
    """16-bit codes, a one-symbol book and equal-length codes: accepted
    and exact. Equal-length codes never resynchronise: at bs 500 (no
    room for the maps) the true starts spread one segment a round, at
    2500 the rounds give way to the candidate maps."""
    assert _maps_fit(2500) and not _maps_fit(500)
    rng = np.random.default_rng(len(book))
    arrays = _book_arrays(rng, book, [4 * bs, 2 * bs, 3], bs)
    verdict, rounds = _check_walk(arrays, bs)
    assert "exact" not in verdict.values()
    if book == "equal_length":
        # 79- and 391-bit segments of 10-bit codes: only every tenth
        # segment's guess is a boundary
        if bs == 2500:
            assert rounds == MAP_AFTER + CANDIDATES
        else:
            assert 8 <= rounds <= SEGS - 1


def test_model_rejects_where_bitflips_change_the_walk():
    """The corpus's bitflip cases on a valid stream: where the fast
    path's symbols differ from the walk the rule rejects, and the model
    decodes each corrupted row as walk_plain does."""
    corpus = json.load(open(CORPUS))
    cases = [c for c in corpus["cases"] if c["kind"] == "bitflip"]
    rng = np.random.default_rng(corpus["random"]["seed"])
    for _ in range(8):
        cases.append({"record": int(rng.integers(3)),
                      "rel_off": int(rng.integers(1 << 16)),
                      "bit": int(rng.integers(8))})
    arrays, _ = _stage(np.random.default_rng(3), [2048, 1500, 700], 256)
    n_exact = 0
    for case in cases:
        a = dict(arrays, words2=arrays["words2"].copy())
        r = case["record"] % a["words2"].shape[0]
        payload = a["words2"][r].view(np.uint8)
        payload[case["rel_off"] % payload.size] ^= 1 << (case["bit"] & 7)
        verdict, _ = _check_walk(a, 256)
        n_exact += list(verdict.values()).count("exact")
    assert n_exact > 0


def test_model_on_garbage():
    """The corpus's garbage cases (random words, tables with length-0
    entries, random bit counts) and one word-tiled case: the model's
    blocks equal walk_plain's; some are rejected."""
    n_exact = 0
    for bs, args in _garbage_cases():
        arrays = dict(zip(KEYS, args[:6]))
        if arrays["nbits2"].shape[1] * bs > TM.DEC_FUSE_LIMIT:
            continue          # the tiled case: a word-tiled row below
        verdict, _ = _check_walk(arrays, bs, tiled=False)
        n_exact += list(verdict.values()).count("exact")
    rng = np.random.default_rng(9)
    NB, bs = 9, 256
    arrays = dict(
        words2=rng.integers(0, 1 << 32, (2, 40), dtype=np.uint32),
        nbits2=rng.integers(0, 1 << 12, (2, NB)).astype(np.int32),
        counts=np.array([NB * bs, 1000], np.int32),
        sym_flat=rng.integers(0, 1024, 1 << 16).astype(np.int32),
        len_flat=rng.integers(0, 17, 1 << 16).astype(np.int32),
        cb_idx=np.zeros(2, np.int32))
    verdict, _ = _check_walk(arrays, bs)
    n_exact += list(verdict.values()).count("exact")
    assert n_exact > 0


def _flipped(arrays, cases):
    """Copies of `arrays` with one corpus bitflip each."""
    for case in cases:
        a = dict(arrays, words2=arrays["words2"].copy())
        r = case["record"] % a["words2"].shape[0]
        payload = a["words2"][r].view(np.uint8)
        payload[case["rel_off"] % payload.size] ^= 1 << (case["bit"] & 7)
        yield a


@pytest.mark.parametrize("case", ["valid", "bitflips", "garbage",
                                  "equal_length"])
def test_model_with_one_window_a_row(case):
    """The split route's walk on the card is the warp walk with one window
    a row in tiles of one block (hufdec/ops.py::row_geometry): the model in
    that geometry against walk_plain there, which is hufdec_plain, on
    valid streams, the corpus's bitflips, its garbage and a book that never
    resynchronises; every valid block is kept from the fast path, and some
    corrupted blocks are rejected."""
    rng = np.random.default_rng(21)
    if case == "valid":
        runs = [(_stage(rng, [4096, 700, 37], 512)[0], 512)]
    elif case == "bitflips":
        corpus = json.load(open(CORPUS))
        flips = [c for c in corpus["cases"] if c["kind"] == "bitflip"]
        r = np.random.default_rng(corpus["random"]["seed"])
        flips += [{"record": int(r.integers(3)),
                   "rel_off": int(r.integers(1 << 16)),
                   "bit": int(r.integers(8))} for _ in range(8)]
        base = _stage(np.random.default_rng(3), [2048, 1500, 700], 256)[0]
        runs = [(a, 256) for a in _flipped(base, flips)]
    elif case == "garbage":
        runs = [(dict(zip(KEYS, args[:6])), bs)
                for bs, args in _garbage_cases()]
    else:
        runs = [(_book_arrays(rng, "equal_length", [2000, 1000, 3], 500),
                 500)]
    n_exact = 0
    for arrays, bs in runs:
        W = arrays["words2"].shape[1]
        verdict, _ = _check_walk(arrays, bs, geometry=TH.row_geometry(W))
        got = _model_walk(arrays, bs, *TH.row_geometry(W))[0]
        want = TH.hufdec_plain(*(_torch(arrays[k]) for k in KEYS), bs)
        np.testing.assert_array_equal(got, want.numpy())
        n_exact += list(verdict.values()).count("exact")
    if case in ("valid", "equal_length"):
        assert n_exact == 0
    else:
        assert n_exact > 0


def test_packed_table16_decodes_like_packed_table():
    """The 16-bit entry holds the 32-bit one's symbol and length for every
    entry in range."""
    rng = np.random.default_rng(12)
    sym = torch.from_numpy(rng.integers(0, 1024, 1 << 17).astype(np.int32))
    ln = torch.from_numpy(rng.integers(0, 17, 1 << 17).astype(np.uint8))
    t32 = TH.packed_table(sym, ln)
    t16 = TH.packed_table16(sym, ln).to(torch.int32)
    assert torch.equal(t16 & 1023, t32 & 0xFFFF)
    assert torch.equal(t16 >> 10, t32 >> 16)


@pytest.mark.parametrize("bad_sym,bad_len", [(1024, 3), (-1, 3), (5, 17),
                                             (5, -1)])
def test_table_ranges_raise_out_of_range(bad_sym, bad_len):
    """One entry outside sym [0, 1024) or len [0, 16]: the 16-bit packer
    raises, and so does the range check on the host's numpy tables."""
    rng = np.random.default_rng(13)
    sym = rng.integers(0, 1024, 1 << 16).astype(np.int32)
    ln = rng.integers(0, 17, 1 << 16).astype(np.int32)
    TH.check_table_ranges(sym, ln)
    sym[77], ln[77] = bad_sym, bad_len
    with pytest.raises(ValueError):
        TH.packed_table16(torch.from_numpy(sym), torch.from_numpy(ln))
    with pytest.raises(ValueError):
        TH.check_table_ranges(sym, ln)


def test_marked_tables_lose_the_mark_when_changed():
    """A table the caller checked on the host keeps its mark until it is
    changed in place; an unmarked table, or an inference tensor, has
    none."""
    sym = torch.zeros(TH.TBL, dtype=torch.int32)
    ln = torch.zeros(TH.TBL, dtype=torch.int32)
    TH.mark_ranges_checked(sym, ln)
    assert TH.ranges_checked(sym) and TH.ranges_checked(ln)
    ln[3] = 17
    assert TH.ranges_checked(sym) and not TH.ranges_checked(ln)
    assert not TH.ranges_checked(torch.zeros(TH.TBL, dtype=torch.int32))
    with torch.inference_mode():
        t = torch.zeros(TH.TBL, dtype=torch.int32)
        TH.mark_ranges_checked(t)
        assert not TH.ranges_checked(t)


def _two_row_batch(book, seg0, bs=256):
    """-> (a _ChunkBatch of two Lorenzo rows encoded with `book`, no
    escapes; their codes)."""
    rng = np.random.default_rng(4)
    batch = _ChunkBatch(bs, "cpu")
    rows = [rng.integers(1, 1024, n) for n in (700, 300)]
    for codes, head in zip(rows, seg0):
        n = len(codes)
        w64, bnb, _ = encode(codes, book, bs)
        batch.words.append(_u64_to_u32(w64))
        batch.nbits.append(np.asarray(bnb, np.int64))
        batch.counts.append(n)
        batch.books.append(book)
        batch.odelta.append(np.zeros(0, np.int32))
        batch.base.append(0)
        batch.islor.append(1)
        batch.seg0.append(head)
    batch.spans.append((0, 2))
    return batch, rows


@pytest.mark.parametrize("fault", ["none", "symbol_1024", "seg0_after_row"])
def test_decode_pass_checks_tables_and_segments_on_the_host(fault,
                                                            monkeypatch):
    """The decode pass checks each book's table ranges and each row's
    segment head on the host and hands the op tables marked as checked
    (so the warp walks' wrappers need not wait on the card); a book with
    a symbol >= 1024 or a head past its row raises before the op."""
    book = Codebook.from_freqs(np.ones(1025 if fault == "symbol_1024"
                                       else 1024, np.int64))
    batch, rows = _two_row_batch(book, [0, 2] if fault == "seg0_after_row"
                                 else [0, 0])
    seen = []

    def op(*args):
        seen.append(TH.ranges_checked(args[3]) and TH.ranges_checked(args[4]))
        return TM.ceaz_chunk_dec_plain(*args)
    monkeypatch.setattr(fd.dispatch, "resolve", lambda *a: op)
    if fault != "none":
        with pytest.raises(ValueError):
            batch.run_mega()
        assert not seen
        return
    q = batch.run_mega().numpy()
    assert seen == [True]
    # one Lorenzo chain over both rows: q is the running sum of code - 512
    want = np.cumsum(np.concatenate(rows) - 512)
    np.testing.assert_array_equal(q[0, :700], want[:700])
    np.testing.assert_array_equal(q[1, :300], want[700:])
