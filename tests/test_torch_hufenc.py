"""Pass-2 parity: the port's `hufenc` gather-pack op (plain version — the
one the card's kernel is held against) vs the reference's jnp
``encode_pack`` and its gather-pack Pallas kernel (interpret mode).
Bitwise: payload words and per-block bit counts.

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
from repro.kernels.hufenc import ref as ER
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
