"""The port's fixed-width compressed all-gather
(src/repro_torch/io/collectives.py) against the JAX reference's
``compressed_all_gather`` run under ``shard_map`` on 4 host devices, and
the ``torch.distributed`` form (gloo, world size 2) against the
no-group form, on the CPU.

What is held, and to what:
  * packed words and scales: bitwise against the reference's
    ``_encode_local``;
  * non-Lorenzo decoded values: bitwise (one f32 product a value), and
    within 0.5*scale + 2^-23*max|x| of the input (``step_bound``);
  * Lorenzo decoded values, the port's and the reference's: against the
    float64 prefix sum of the same dequantised residuals, the port's
    within the error bound of its two-level blocked scan, the reference's
    within that of an f32 scan of any association, ((1 + 2^-24)^i - 1) *
    sum_{j<=i} |r^_j|; both against the input within the open-loop bound
    (``lorenzo_bounds``).
"""
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SRC, run_with_devices
from repro.io import collectives as RCOL
from repro_torch.io import collectives as COL
from repro_torch.optim import grad_compress as GC

CASES = [(8, True), (8, False), (4, True), (4, False)]


def _shards(R=4, n=4099, seed=0):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal((R, n)), axis=1) / 50).astype(
        np.float32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's gather of the same shards, each case, under a
    4-device shard_map (one subprocess)."""
    out = tmp_path_factory.mktemp("ref") / "gather.npz"
    np.save(out.with_suffix(".x.npy"), _shards())
    run_with_devices(textwrap.dedent(f"""
        import jax, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.io.collectives import compressed_all_gather, WireFormat
        from repro.launch import mesh as M
        mesh = M.make_mesh((4,), ('ranks',))
        x = np.load({str(out.with_suffix('.x.npy'))!r})
        xs = jax.device_put(x, NamedSharding(mesh, P('ranks', None)))
        res = {{}}
        for bits, lor in {CASES!r}:
            g = compressed_all_gather(xs, mesh, 'ranks',
                                      WireFormat(bits=bits, use_lorenzo=lor))
            res[f'{{bits}}_{{lor}}'] = np.asarray(g)
        np.savez({str(out)!r}, **res)
    """), n_devices=4)
    return dict(np.load(out))


@pytest.mark.parametrize("bits,lor", CASES)
def test_all_gather_matches_reference(reference, bits, lor):
    x = _shards()
    wire = COL.WireFormat(bits=bits, use_lorenzo=lor)
    got = COL.compressed_all_gather(torch.from_numpy(x), wire,
                                    device="cpu").numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    ref = reference[f"{bits}_{lor}"]          # (R, R*1, n): rank r's view
    for r in range(4):
        # words and scales, rank by rank, against the reference's encode
        pk, sc = jax.jit(RCOL._encode_local, static_argnums=(1, 2))(
            jnp.asarray(x[r]), bits, lor)
        words, scale = COL._encode_local(torch.from_numpy(x[r:r + 1]), bits,
                                         lor)
        np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                      np.asarray(pk))
        assert scale.numpy()[0].tobytes() == np.asarray(sc).tobytes()
        codes = GC.BP.unpack_words(words, x.shape[1], bits)
        resid_hat = GC.dequantize_rows(codes[None], scale, bits)[0].numpy()
        if lor:
            r32 = np.diff(x[r], prepend=np.float32(0))
            assert np.abs(resid_hat.astype(np.float64) - r32).max() <= \
                COL.step_bound(sc, np.abs(r32).max())
            # the port's decode (its blocked scan) and each reference
            # rank's (XLA's cumsum, any association)
            block = COL.sqrt_block(x.shape[1])
            for dec, blk in [(got[r], block)] + [(ref[r, v], None)
                                                  for v in range(4)]:
                S, scan, open_loop = COL.lorenzo_bounds(x[r], resid_hat, sc,
                                                        blk)
                dec = dec.astype(np.float64)
                assert np.all(np.abs(dec - S) <= scan)
                assert np.all(np.abs(dec - x[r]) <= open_loop)
        else:
            for v in range(4):
                assert ref[r, v].tobytes() == got[r].tobytes()
            assert np.abs(got[r].astype(np.float64) - x[r]).max() <= \
                COL.step_bound(sc, np.abs(x[r]).max())


@pytest.mark.parametrize("n", [1, 63, 4099, 70001])
def test_blocked_scan_within_its_bound(n):
    """blocked_cumsum against the float64 prefix sum, within the bound of
    its two-level structure, on lengths that leave a ragged last block."""
    rng = np.random.default_rng(n)
    r = rng.standard_normal((2, n)).astype(np.float32) * np.float32(1e3)
    block = COL.sqrt_block(n)
    dec = COL.blocked_cumsum(torch.from_numpy(r), block).numpy()
    assert dec.shape == (2, n) and dec.dtype == np.float32
    for row in range(2):
        S, scan, _ = COL.lorenzo_bounds(np.zeros(n, np.float32), r[row],
                                        1.0, block)
        assert np.all(np.abs(dec[row].astype(np.float64) - S) <= scan)


def test_blocked_scan_bound_catches_a_miscarried_block():
    """A decode that drops one block's total from the carry fails the
    bound (positive residuals: the total dwarfs the rounding)."""
    n, rng = 1 << 16, np.random.default_rng(1)
    r = rng.uniform(0.5, 1.5, (1, n)).astype(np.float32)
    block = COL.sqrt_block(n)
    dec = COL.blocked_cumsum(torch.from_numpy(r), block).numpy()[0]
    S, scan, _ = COL.lorenzo_bounds(np.zeros(n, np.float32), r[0], 1.0,
                                    block)
    assert np.all(np.abs(dec.astype(np.float64) - S) <= scan)
    bad = dec.copy()
    bad[7 * block:] -= r[0, 3 * block:4 * block].sum()
    assert not np.all(np.abs(bad.astype(np.float64) - S) <= scan)


@pytest.mark.parametrize("lor", [True, False])
def test_nonfinite_ranks_match_reference(lor):
    """A rank holding NaN or +-Inf: its scale is NaN or Inf, NaN codes as
    0 (XLA's cast), and the words and scales equal the reference's."""
    x = _shards(R=3, n=1001, seed=1)
    x[0, 17] = np.nan
    x[1, 5] = np.inf
    x[2, 900] = -np.inf
    for bits in (8, 2):
        got = COL.compressed_all_gather(x, COL.WireFormat(bits, lor),
                                        device="cpu").numpy()
        for r in range(3):
            pk, sc = jax.jit(RCOL._encode_local, static_argnums=(1, 2))(
                jnp.asarray(x[r]), bits, lor)
            words, scale = COL._encode_local(torch.from_numpy(x[r:r + 1]),
                                             bits, lor)
            np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                          np.asarray(pk))
            assert scale.numpy()[0].tobytes() == np.asarray(sc).tobytes()
            dec = jax.jit(RCOL._decode_local, static_argnums=(2, 3, 4))(
                pk, sc, x.shape[1], bits, lor)
            np.testing.assert_array_equal(np.isnan(got[r]),
                                          np.isnan(np.asarray(dec)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_GLOO = textwrap.dedent("""
    import sys, numpy as np, torch, torch.distributed as dist
    from repro_torch.io import collectives as COL
    from repro_torch.optim import grad_compress as GC
    rank, port, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    d = np.load(inp)
    res = {}
    for bits, lor in ((8, True), (4, False)):
        g = COL.compressed_all_gather(torch.from_numpy(d["x"][rank]),
                                      COL.WireFormat(bits, lor),
                                      group=dist.group.WORLD, device="cpu")
        res[f"gather_{bits}_{lor}"] = g.numpy()
    grads = {k[2:]: torch.from_numpy(d[k][rank]) for k in d.files
             if k.startswith("g_")}
    resid = {k: torch.zeros_like(v) for k, v in grads.items()}
    for step in range(2):
        mean, resid = GC.compressed_cross_pod_mean(
            grads, resid, GC.CompressionConfig(bits=8),
            group=dist.group.WORLD, device="cpu")
        for k in grads:
            res[f"mean{step}_{k}"] = mean[k].numpy()
            res[f"res{step}_{k}"] = resid[k].numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def gloo_world2(tmp_path_factory):
    """Two processes on a gloo group, each with its own rank's shard and
    pod gradients; their results."""
    tmp = tmp_path_factory.mktemp("gloo")
    rng = np.random.default_rng(7)
    data = {"x": _shards(R=2, n=3001, seed=2),
            "g_w": rng.standard_normal((2, 33, 7)).astype(np.float32),
            "g_b": rng.standard_normal((2, 5)).astype(np.float32)}
    np.savez(tmp / "in.npz", **data)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO, str(r), port, str(tmp / "in.npz"),
         str(tmp / f"out{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
    return data, [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]


def test_gloo_gather_equals_no_group_form(gloo_world2):
    data, outs = gloo_world2
    for bits, lor in ((8, True), (4, False)):
        want = COL.compressed_all_gather(data["x"], COL.WireFormat(bits, lor),
                                         device="cpu").numpy()
        for out in outs:
            assert out[f"gather_{bits}_{lor}"].tobytes() == want.tobytes()


def test_gloo_exchange_equals_no_group_form(gloo_world2):
    data, outs = gloo_world2
    grads = {k[2:]: torch.from_numpy(data[k]) for k in ("g_w", "g_b")}
    resid = {k: torch.zeros_like(v) for k, v in grads.items()}
    for step in range(2):
        mean, resid = GC.compressed_cross_pod_mean(
            grads, resid, GC.CompressionConfig(bits=8), device="cpu")
        for k in grads:
            for rank, out in enumerate(outs):
                assert out[f"mean{step}_{k}"].tobytes() == \
                    mean[k].numpy().tobytes()
                assert out[f"res{step}_{k}"].tobytes() == \
                    resid[k][rank].numpy().tobytes()


def test_deadline_gather_matches_reference():
    shards = [np.full(3, i, np.float32) for i in range(4)]
    fetchers = [lambda i=i: shards[i] for i in range(4)]
    got, ref = COL.DeadlineGather(10.0), RCOL.DeadlineGather(10.0)
    for dl in (10.0, 0.0):
        got.deadline_s = ref.deadline_s = dl
        a, b = got.gather(fetchers), ref.gather(fetchers)
        assert a[1] == b[1] and all(np.array_equal(x, y)
                                    for x, y in zip(a[0], b[0]))
    assert got.stats == ref.stats == {"rounds": 2, "dropped": 4}


def test_gather_entry_points_device_and_not_ported(tmp_path):
    """The Huffman-codec gather is ported: its entry points run on the
    card by default and raise without one; with device='cpu' they run
    (tests/test_torch_gather.py holds them to the reference)."""
    x = _shards(R=2, n=10)
    path = str(tmp_path / "g.ceazs")
    ranks = [np.linspace(0, 1, 64, dtype=np.float32)] * 2
    comps, stats = COL.ceaz_gather(ranks, device="cpu")
    assert stats["n_ranks"] == 2
    COL.ceaz_gather_stream(ranks, path, device="cpu")
    back, _ = COL.read_gather_stream(path, device="cpu")
    assert back[1].tobytes() == COL.ceaz_gather_decode(
        comps, device="cpu")[1].tobytes()
    if not torch.cuda.is_available():
        for fn, args in ((COL.compressed_all_gather, (x,)),
                         (COL.ceaz_gather, ([x[0]],)),
                         (COL.ceaz_gather_decode, ([],)),
                         (COL.read_gather_stream, (path,)),
                         (COL.ceaz_gather_stream,
                          ([x[0]], str(tmp_path / "h.ceazs")))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn(*args)
    assert COL.wire_bytes(4, 4099, 8) == 4 * (4 * 1025 + 4)
