"""Pass-2 parity: the port's `hufenc` gather-pack op (plain version — the
one the card's kernel is held against) vs the reference's jnp
``encode_pack`` and its gather-pack Pallas kernel (interpret mode).
Bitwise: payload words and per-block bit counts.

The staged route's packers: the `hufenc_flat` op's plain version's two
steps, the blocks (``hufenc_blocks_plain``) vs the reference's serial
per-block Pallas ``hufenc`` (interpret mode) and their stitch
(``stitch_plain``) vs the reference's numpy ``to_host_stream``, and
``encode_device`` (on the CPU: the plain versions) vs
``core/huffman.py::encode``.

The reference's word-tiled Pallas kernel (``gather_pack_tiled``) does
not trace under the installed JAX (``pl.unblocked`` is gone); its
contract is bit-identity with ``encode_pack`` and the untiled
``gather_pack``, which both run here and hold the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import huffman as RH
from repro.kernels.hufenc import kernel as EK
from repro.kernels.hufenc import ops as EO
from repro.kernels.hufenc import ref as ER
from repro_torch import convert
from repro_torch.kernels import dispatch
from repro_torch.kernels.hufenc import ops as TO


def _case(rng, C, cv, sigma=40, books=1):
    codes = np.clip(rng.normal(512, sigma, (C, cv)), 0, 1023) \
        .astype(np.int32)
    rows = []
    for k in range(books):
        cb = RH.Codebook.from_freqs(
            np.bincount(codes[k % C].reshape(-1), minlength=1024) + k)
        rows.append(cb)
    lengths = np.stack([rows[i % books].lengths for i in range(C)]) \
        .astype(np.int32)
    cwords = np.stack([rows[i % books].codes for i in range(C)]) \
        .astype(np.uint32)
    return codes, lengths, cwords


def _port(codes, valid, lengths, cwords, bs, w32):
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (codes, valid, lengths, cwords.astype(np.int32))]
    w, nb = dispatch.resolve("hufenc", "auto", "cpu")(*args, bs, w32)
    return w.numpy().view(np.uint32), nb.numpy()


def _check(codes, valid, lengths, cwords, bs, w32, pallas=True):
    pw, pn = _port(codes, valid, lengths, cwords, bs, w32)
    args = (jnp.asarray(codes), jnp.asarray(valid), jnp.asarray(lengths),
            jnp.asarray(cwords))
    rw, rn = ER.encode_pack(*args, bs, w32, 33)
    np.testing.assert_array_equal(pw, np.asarray(rw))
    np.testing.assert_array_equal(pn, np.asarray(rn))
    if pallas:
        kw, kn = EK.gather_pack(*args, block_size=bs, w32=w32,
                                interpret=True)
        np.testing.assert_array_equal(pw, np.asarray(kw))
        np.testing.assert_array_equal(pn, np.asarray(kn))


@pytest.mark.parametrize("w32", [512, 1024, 1200, 8192])
def test_word_tile_boundaries(w32):
    """One- and two-tile capacities, a ragged tail tile and an
    over-provisioned capacity of the reference's 512-word tiling."""
    rng = np.random.default_rng(w32)
    codes, lengths, cwords = _case(rng, 3, 5000, books=3)
    valid = np.ones((3, 5000), bool)
    valid[-1, 4321:] = False
    _check(codes, valid, lengths, cwords, 1024, w32)


@pytest.mark.parametrize("w32", [4, 64, 333])
def test_truncation_at_w32(w32):
    """A capacity below the payload: bits past w32*32 are dropped."""
    rng = np.random.default_rng(11)
    codes, lengths, cwords = _case(rng, 2, 3000, sigma=200)
    valid = np.ones((2, 3000), bool)
    _check(codes, valid, lengths, cwords, 512, w32)


@pytest.mark.parametrize("bs", [1, 32, 4096])
def test_block_grains_and_ragged_rows(bs):
    rng = np.random.default_rng(bs)
    codes, lengths, cwords = _case(rng, 4, 777, sigma=5, books=2)
    valid = np.ones((4, 777), bool)
    valid[1, 500:] = False
    valid[3, :] = False                      # zero-length row
    _check(codes, valid, lengths, cwords, bs, 512)


def test_large_chunk_matches_untiled_reference():
    """A chunk past the TPU's one-program ceiling (~128k values)."""
    rng = np.random.default_rng(5)
    cv = 150_000
    codes, lengths, cwords = _case(rng, 1, cv)
    valid = np.ones((1, cv), bool)
    valid[0, cv - 77:] = False
    need = int(np.sum(lengths[0][codes[0]]))
    w32 = 2 * ((need + 63) // 64 + 1)
    _check(codes, valid, lengths, cwords, 4096, w32, pallas=False)


def test_cuda_impl_refuses_cpu_tensors():
    z = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TO.encode_pack_cuda(z, z.bool(), torch.zeros((1, 1024), dtype=torch.int32),
                            torch.zeros((1, 1024), dtype=torch.int32), 4, 4)


def _book(codes, max_len=16, one_symbol=False):
    freqs = np.bincount(codes.reshape(-1), minlength=1024)
    if one_symbol:
        return RH.Codebook.from_freqs(freqs, smoothing=False,
                                      max_len=max_len)
    return RH.Codebook.from_freqs(freqs, max_len=max_len)


def _tables(cb):
    return (torch.from_numpy(cb.lengths.astype(np.int32)),
            torch.from_numpy(cb.codes.astype(np.uint32).view(np.int32)))


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("sigma", [3, 30, 300])
def test_blocks_packer_matches_pallas_hufenc(sigma, tail):
    """Full 4096-symbol blocks, and a stream whose tail block
    ``hufenc_flat`` pads with symbol 512 (the op packs the n symbols it
    is given, so it gets the padded stream)."""
    rng = np.random.default_rng(sigma)
    n = 5000 if tail else 8192
    x = np.clip(rng.normal(512, sigma, n), 0, 1023).astype(np.int32)
    cb = _book(x)
    kw, kn, _ = EO.hufenc_flat(jnp.asarray(x), jnp.asarray(cb.codes),
                               jnp.asarray(cb.lengths.astype(np.int32)),
                               pad_sym=512)
    padded = np.full(kw.shape[0] * EK.BLOCK, 512, np.int32)
    padded[:n] = x
    ln, cw = _tables(cb)
    rows, nbits = TO.hufenc_blocks_plain(torch.from_numpy(padded), ln, cw,
                                         EK.BLOCK, cb.max_len)
    rows = rows.numpy().view(np.uint32)
    assert rows.shape == (kw.shape[0], EK.WORDS + 1)
    np.testing.assert_array_equal(rows[:, :EK.WORDS], np.asarray(kw))
    assert not rows[:, EK.WORDS:].any()
    np.testing.assert_array_equal(nbits.numpy(), np.asarray(kn))
    # the stitch of those rows is the reference's host stream
    total = int(nbits.sum())
    words = TO.stitch_plain(torch.from_numpy(rows.view(np.int32)), nbits,
                            total)
    stream, bits = EO.to_host_stream(kw, kn, len(padded), cb.lengths)
    assert bits == total
    np.testing.assert_array_equal(
        TO.u32_to_u64(words.numpy().view(np.uint32)), stream)


def _encode_both(codes, cb, bs):
    port_cb = convert.from_reference(cb)
    got = TO.encode_device(torch.from_numpy(codes), port_cb, bs)
    want = RH.encode(codes, cb, bs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64
    return got


@pytest.mark.parametrize("max_len", [12, 16])
@pytest.mark.parametrize("bs", [16, 1024, 4096])
@pytest.mark.parametrize("n", [1, 4097, 3 * 4096, 1 << 16, (1 << 16) + 1,
                               70001])
def test_encode_device_matches_huffman_encode(n, bs, max_len):
    """n = 1, odd n, exact multiples of every block size and of the
    gather_pack tile, 2^16 and 2^16+1 values."""
    rng = np.random.default_rng(n + bs)
    codes = np.clip(rng.normal(512, 40, n), 0, 1023).astype(np.int32)
    _encode_both(codes, _book(codes, max_len), bs)


@pytest.mark.parametrize("n", [1, 999, (1 << 16) + 7])
def test_encode_device_one_symbol_book(n):
    """1-bit codes: with 16-symbol blocks an output word gathers the bits
    of two blocks."""
    codes = np.full(n, 512, np.int32)
    cb = _book(codes, one_symbol=True)
    assert int(cb.lengths.sum()) == 1
    words, nbits, total = _encode_both(codes, cb, 16)
    assert total == n and nbits[0] == min(n, 16)


def test_encode_device_refuses_an_uncovering_book():
    codes = np.array([512, 512, 3], np.int32)
    cb = _book(np.full(8, 512, np.int32), one_symbol=True)
    with pytest.raises(ValueError, match="does not cover"):
        RH.encode(codes, cb, 16)
    with pytest.raises(ValueError, match="does not cover"):
        TO.encode_device(torch.from_numpy(codes), convert.from_reference(cb),
                         16)


def test_new_cuda_impls_refuse_cpu_tensors():
    z = torch.zeros(8, dtype=torch.int32)
    t = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TO.hufenc_cuda(z, t, t, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        TO.gather_pack_cuda(z.reshape(1, 8), z.reshape(1, 8).bool(),
                            t.reshape(1, -1), t.reshape(1, -1), 4, 4)


def _encode_through_both_packers(codes, cb, bs, monkeypatch):
    """With the rule's constant put at n, then at n - 1, the same chunk
    packs through `gather_pack`, then through `hufenc_flat` (their
    plain versions here): the same (words,
    block_nbits, total) as ``huffman.encode`` both times."""
    n = codes.size
    resolve, asked = TO.dispatch.resolve, []

    def spy(op, *a):
        asked.append(op)
        return resolve(op, *a)
    monkeypatch.setattr(TO.dispatch, "resolve", spy)
    outs = []
    for limit, packer in ((n, "gather_pack"), (n - 1, "hufenc_flat")):
        monkeypatch.setattr(TO, "GATHER_PACK_MAX_VALUES", limit)
        asked.clear()
        outs.append(_encode_both(codes, cb, bs))
        assert packer in asked
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    return outs[0]


@pytest.mark.parametrize("max_len", [12, 16])
@pytest.mark.parametrize("bs", [16, 1024, 4096])
@pytest.mark.parametrize("n", [1, 4097, 3 * 4096, 1 << 15, (1 << 15) + 1,
                               1 << 16, (1 << 16) + 1, 70001])
def test_encode_device_packers_agree_on_each_side_of_the_rule(
        n, bs, max_len, monkeypatch):
    """Both packers at every block size and length limit, on n = 1, odd
    n and exact multiples of every block size and of the gather_pack
    tile."""
    rng = np.random.default_rng(n + bs)
    codes = np.clip(rng.normal(512, 40, n), 0, 1023).astype(np.int32)
    _encode_through_both_packers(codes, _book(codes, max_len), bs,
                                 monkeypatch)


@pytest.mark.parametrize("n", [1, 999, (1 << 16) + 7])
def test_encode_device_packers_agree_on_a_one_symbol_book(n, monkeypatch):
    """1-bit codes in 16-symbol blocks through both packers: an output
    word of either gathers the bits of two blocks."""
    codes = np.full(n, 512, np.int32)
    cb = _book(codes, one_symbol=True)
    words, nbits, total = _encode_through_both_packers(codes, cb, 16,
                                                       monkeypatch)
    assert total == n and nbits[0] == min(n, 16)


@pytest.mark.parametrize("C,cv,tiles", [(1, 1, 1), (1, 1 << 15, 8),
                                        (1, (1 << 15) + 1, 9),
                                        (1, 1 << 23, 2048),
                                        (70000, 3, 1), (3, 70001, 18)])
def test_gather_pack_plan(C, cv, tiles):
    """The one zeroed buffer of a pack launch: words, then block_nbits,
    each from an int64 boundary, then the kernel's scratch (here the size
    csrc/hufenc.cu gives C rows of `tiles` 4096-symbol tiles: a 64-bit
    status word a tile, then one 64-bit ticket counter), nothing
    overlapping."""
    assert tiles == -(-cv // 4096)
    scratch = 8 * C * tiles + 8
    for bs, w32 in ((16, 1), (4096, 2 * (16 * cv // 64 + 1))):
        nblocks = max(1, -(-cv // bs))
        size, at_nbits, at_scratch = TO.gather_pack_plan(C, nblocks, w32,
                                                         scratch)
        assert 2 * at_nbits >= C * w32 and 2 * at_nbits - C * w32 < 2
        assert 2 * (at_scratch - at_nbits) >= C * nblocks
        assert 2 * (at_scratch - at_nbits) - C * nblocks < 2
        assert 8 * (size - at_scratch) >= scratch
        assert 8 * (size - at_scratch) - scratch < 8
