"""Replay the decode fuzz corpus's garbage cases through the table walks.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/walk_garbage_probe.py

(a script beside the tests, not collected by pytest)

On corrupted bits a walk's cursor can leave its row. The walks handle
that differently, and this probe counts where their codes differ from
the port's `hufdec` walk (``repro_torch/kernels/hufdec/ops.py``, the
plain version its CUDA kernel is held against):

  * the reference's jnp walk (``repro/kernels/hufdec/ref.py::
    decode_blocks``, the split route's default off the TPU) gathers
    with ``take_along_axis``: a word past the row reads as 0xFFFFFFFF,
    a negative index wraps once;
  * the reference's Pallas ``hufdec`` kernel (interpret mode) indexes
    the loaded row directly;
  * the Pallas decode megakernel's walk (``ceaz_chunk_dec_fused``,
    read back through an identity patch) clamps the cursor into the row
    and reads zeros past it, as the port does.

On valid streams all four agree (tests/test_torch_split.py). Prints one
line per walk: garbage cases with any differing position, and
differing positions over all positions.
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro.kernels.hufdec import kernel as HDK  # noqa: E402
from repro.kernels.hufdec import ref as HDR  # noqa: E402
from repro.kernels.megakernel import decode_kernel as DK  # noqa: E402
from repro_torch.kernels.hufdec import ops as TH  # noqa: E402
from repro_torch.kernels.megakernel import ops as TM  # noqa: E402

CORPUS = os.path.join(ROOT, "tests", "corpus", "decode_fuzz_corpus.json")


def garbage_cases():
    """The op-level garbage cases of the corpus in the fused regime,
    drawn as tests/test_torch_decode.py::_garbage_cases draws them."""
    g = json.load(open(CORPUS))["garbage"]
    rng = np.random.default_rng(g["seed"])
    shapes = [(int(rng.integers(1, 4)), int(rng.integers(1, 7)), 32)
              for _ in range(g["cases"])]
    for C, NB, bs in shapes:
        W = int(rng.integers(3, 24))
        walk = [rng.integers(0, 1 << 32, size=(C, W), dtype=np.uint32),
                rng.integers(0, 1 << 12, size=(C, NB)).astype(np.int32),
                rng.integers(0, NB * bs + 1, size=C).astype(np.int32),
                rng.integers(0, 1024, size=(1 << 16,)).astype(np.uint16),
                rng.integers(0, 17, size=(1 << 16,)).astype(np.uint8),
                np.zeros(C, np.int32)]
        # the decode metadata's draws, kept so the stream stays aligned
        rng.integers(-999, 999, size=(C, 4))
        rng.integers(-5, 6, size=C)
        rng.integers(0, 2, size=C)
        yield bs, walk


def port_walk(walk, bs):
    t = [torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32
        else a.astype(np.int32))) for a in walk]
    return TH.hufdec_plain(*t, bs).numpy()


def ref_walk(walk, bs):
    return np.asarray(HDR.decode_blocks(*(jnp.asarray(a) for a in walk),
                                        bs)).astype(np.int32)


def pallas_hufdec(walk, bs):
    words, nbits, counts, sym, ln, cb = walk
    out = HDK.hufdec(jnp.asarray(words), jnp.asarray(nbits),
                     jnp.asarray(counts),
                     jnp.asarray(sym).reshape(1, -1).astype(jnp.int32),
                     jnp.asarray(ln).reshape(1, -1).astype(jnp.int32),
                     jnp.asarray(cb), block_size=bs, interpret=True)
    return np.asarray(out).reshape(out.shape[0], -1)


def megakernel_walk(walk, bs):
    words, nbits, counts, sym, ln, cb = walk
    C = words.shape[0]
    out = DK.ceaz_chunk_dec_fused(
        jnp.asarray(words), jnp.asarray(nbits), jnp.asarray(counts),
        jnp.asarray(sym).reshape(1, -1).astype(jnp.int32),
        jnp.asarray(ln).reshape(1, -1).astype(jnp.int32), jnp.asarray(cb),
        jnp.full((C, 1), -512, jnp.int32), jnp.full(C, 512, jnp.int32),
        jnp.arange(C, dtype=jnp.int32), jnp.zeros(C, jnp.int32),
        block_size=bs, interpret=True)
    return np.asarray(out)


def main():
    walks = {"ref.decode_blocks (jnp)": ref_walk,
             "Pallas hufdec (interpret)": pallas_hufdec,
             "Pallas decode megakernel walk (interpret)": megakernel_walk}
    cases = list(garbage_cases())
    assert all(w[1].shape[1] * bs <= TM.DEC_FUSE_LIMIT for bs, w in cases)
    for name, fn in walks.items():
        n_cases = n_pos = total = 0
        for bs, walk in cases:
            port = port_walk(walk, bs)
            diff = port != fn(walk, bs)
            n_cases += bool(diff.any())
            n_pos += int(diff.sum())
            total += diff.size
        print(f"{name}: {n_cases} of {len(cases)} garbage cases differ "
              f"from the port's hufdec; {n_pos} of {total} positions")


if __name__ == "__main__":
    main()
