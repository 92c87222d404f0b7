"""The port's ``.ceazs`` stream engine (``repro_torch/io/engine.py``),
file write (``io/filewrite.py``), telemetry manifest and report CLI
(``obs/manifest.py``, ``obs/report.py``), on the CPU.

Two halves. Against the reference (same numpy inputs, both packages):
with ``telemetry=False`` the port's ``write_stream`` file equals the
reference's byte for byte over fused abs/rel, staged, bank, fixed-ratio,
float64 and value-direct shards; each package reads the other's stream
to the same decoded bytes; the ``bytes`` codec writes a bfloat16 or
float8 tensor as the reference writes the ml_dtypes array of the same
bits. Then the reference's own engine, manifest and report cases
(``tests/test_engine.py``, ``tests/test_obs.py``) run against the port:
ordered commit, overlap accounting, backpressure, crash safety of the
read side, the stream-level fuzz corpus over the port's staged, split
and mega decode routes, and the CLI's exit codes.
"""
import json
import os
import struct
import sys
import threading
import time
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import CEAZ as RCEAZ
from repro.core import CEAZConfig as RConfig
from repro.io import engine as RE
from repro.io import filewrite as RFW
from repro.obs import manifest as RM
from repro_torch.core import CEAZ, CEAZConfig
from repro_torch.data import fields as F
from repro_torch.io import engine as E
from repro_torch.io import filewrite as FW
from repro_torch.obs import manifest as M
from repro_torch.obs import metrics as om
from repro_torch.obs import report
from repro_torch.obs import trace as ot

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "corpus"))
import stream_cases  # noqa: E402  (the corpus replay, shared with W.fuzz)


def _port(**kw):
    return CEAZ(CEAZConfig(device="cpu", **{"mode": "rel", "eb": 1e-4,
                                            "use_fused": True, **kw}))


@pytest.fixture(scope="module")
def shards():
    return [F.nyx_proxy(seed=s) for s in range(4)]


def _write(path, shards, **kw):
    return E.write_stream(str(path), shards, _port(), fsync=False, **kw)


def _bound(x, eb=1e-4):
    return eb * (float(x.max()) - float(x.min()))


# -- the port against the reference -------------------------------------------

def _walk(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(n)).astype(dtype)


def _hacc(n_shards=2, n=1 << 15):
    return list(F.hacc_proxy(seed=0).reshape(-1)[:n_shards * n]
                .reshape(n_shards, n))


def _cases():
    rng = np.random.default_rng(3)
    x64 = np.cumsum(rng.standard_normal((64, 256))).reshape(64, 256)
    noise = rng.standard_normal(20000).astype(np.float32)
    nyx = [F.nyx_proxy(seed=s) for s in range(3)]
    return {
        # name: (shards, the port's config, the reference's)
        "fused-rel": (nyx, {}, {}),
        "fused-abs": (nyx, dict(mode="abs", eb=1e-2), dict(mode="abs",
                                                           eb=1e-2)),
        "fused-chunks": ([_walk(30000, s) for s in range(3)],
                         dict(adaptive=False, chunk_bytes=1 << 13),
                         dict(adaptive=False, chunk_bytes=1 << 13)),
        "staged-torch": (nyx[:2], dict(use_fused=False),
                         dict(use_fused=False, backend="jax")),
        "staged-numpy": (nyx[:2], dict(use_fused=False, backend="numpy"),
                         dict(use_fused=False, backend="numpy")),
        "bank": (_hacc(), dict(codebook="bank"), dict(codebook="bank")),
        "fixed-ratio": (_hacc(), dict(mode="fixed_ratio", target_ratio=8.0,
                                      chunk_bytes=1 << 14),
                        dict(mode="fixed_ratio", target_ratio=8.0,
                             chunk_bytes=1 << 14)),
        "float64": ([x64, x64 * 2.0], dict(eb=1e-5), dict(eb=1e-5)),
        "value-direct": ([noise], dict(predictor="none"),
                         dict(predictor="none")),
    }


CASES = _cases()


def _both(tmp_path, name, group=2):
    shards, pkw, rkw = CASES[name]
    port = _port(**pkw)
    ref = RCEAZ(RConfig(**{"mode": "rel", "eb": 1e-4, "use_fused": True,
                           **rkw}))
    p, r = str(tmp_path / "port.ceazs"), str(tmp_path / "ref.ceazs")
    E.write_stream(p, shards, port, fsync=False, telemetry=False,
                   group=group)
    RE.write_stream(r, shards, ref, fsync=False, telemetry=False,
                    group=group)
    return p, r, port, ref, shards


@pytest.mark.parametrize("name", sorted(CASES))
def test_write_stream_bytes_equal_reference(tmp_path, name):
    """telemetry=False: the port's file is the reference's, byte for
    byte — payload pickles under the reference's class path, index rows,
    footer meta (block grain, codebook bank) and trailer."""
    p, r, _, _, _ = _both(tmp_path, name)
    a, b = open(p, "rb").read(), open(r, "rb").read()
    assert len(a) == len(b)
    assert a == b


@pytest.mark.parametrize("name", ["fused-rel", "staged-torch", "bank",
                                  "fixed-ratio", "float64", "value-direct"])
def test_each_package_reads_the_others_stream(tmp_path, name):
    """The port decodes the reference's stream, and the reference the
    port's, to the bytes the reference decodes its own stream to."""
    p, r, port, ref, shards = _both(tmp_path, name)
    want = RE.read_stream_arrays(r, ref, sync=True)
    for got in (E.read_stream_arrays(r, port, sync=True),
                E.read_stream_arrays(r, device="cpu"),
                RE.read_stream_arrays(p, ref, sync=True)):
        assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    with E.StreamReader(r) as rd:
        for i, (rec, obj) in enumerate(rd.iter_objects()):
            assert type(obj) is E.CEAZCompressed
            assert E.serialize_payload(obj)[0] == rd.payload(i)


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn",
                                   "float8_e5m2"])
def test_bytes_codec_matches_ml_dtypes(dtype):
    """A bfloat16/float8 tensor takes the `bytes` codec of
    docs/STREAM_FORMAT.md: the C-order bytes of the ml_dtypes array with
    the same bits, under its shape and dtype name. The reference reads
    the payload back to that array, and the port reads it to a CPU
    tensor of the same bits.

    The reference's own writer takes that codec only where the dtype's
    name is missing from ``np.sctypeDict``; ml_dtypes 0.5 registers its
    types there, so under it the reference writes such an array as npy
    with a void descr, which the port reads to the same tensor when the
    record's meta names the dtype (as the reference's checkpoint rows
    do)."""
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((3, 5, 7)).astype(getattr(ml_dtypes, dtype))
    width = torch.int16 if dtype == "bfloat16" else torch.uint8
    t = torch.from_numpy(arr.view(f"i{arr.itemsize}").copy()) \
        .view(getattr(torch, dtype))
    pay, meta = E.serialize_payload(t)
    assert (pay, meta) == (arr.tobytes(), {"codec": "bytes",
                                           "shape": [3, 5, 7],
                                           "dtype": dtype})
    rback = RE.deserialize_payload(pay, meta)
    assert rback.dtype == arr.dtype and rback.tobytes() == arr.tobytes()
    back = E.deserialize_payload(pay, meta)
    assert back.dtype == t.dtype and back.shape == t.shape
    assert back.device.type == "cpu"
    assert torch.equal(back.view(width), t.view(width))
    bio = __import__("io").BytesIO()
    np.save(bio, arr.view(f"V{arr.itemsize}"), allow_pickle=False)
    payloads = [bio.getvalue()]
    if arr.dtype.kind == "V":       # what the reference writes here
        payloads.append(RE.serialize_payload(arr)[0])
    for payload in payloads:
        v = E.deserialize_payload(payload, {"codec": "npy", "dtype": dtype})
        assert v.dtype == t.dtype and torch.equal(v.view(width),
                                                  t.view(width))


def test_read_engine_yields_bytes_leaves_as_tensors(tmp_path):
    """A stream of `bytes`-codec leaves reads back through the engine as
    CPU tensors of their dtype, counted in the read stats' raw bytes."""
    path = str(tmp_path / "leaves.ceazs")
    leaves = [torch.arange(12, dtype=torch.float32).to(dt).reshape(3, 4)
              for dt in (torch.bfloat16, torch.float8_e4m3fn)]
    w = E.StreamWriter(path, meta={"block_size": 4096}, fsync=False)
    for i, t in enumerate(leaves):
        w.append(f"leaf{i}", *E.serialize_payload(t))
    w.close()
    with E.AsyncDecodeReadEngine(path, device="cpu") as eng:
        got = [o for _, o in eng]
    for a, b in zip(got, leaves):
        assert a.dtype == b.dtype and torch.equal(a.float(), b.float())
    assert eng.stats.raw_bytes == 12 * 2 + 12


def test_bytes_codec_refuses_other_tensors():
    with pytest.raises(TypeError, match="no stream codec"):
        E.serialize_payload(torch.zeros(3))


def test_reader_refuses_foreign_globals(tmp_path):
    """A `ceaz` record may name only the two record classes and numpy's
    reconstructors: anything else is refused without being imported."""
    import pickle
    for obj in (os.getcwd, threading.Thread, {"x": struct.pack}):
        with pytest.raises(E.StreamCorruptionError, match="refused"):
            E.deserialize_payload(pickle.dumps(obj, protocol=4),
                                  {"codec": "ceaz"})


def test_manifest_matches_reference_module():
    """The copy keeps the reference's schema and fingerprint function:
    equal on the same dict; the port's CEAZConfig (device, no trace)
    fingerprints differently from the reference's, as expected."""
    cfg = {"mode": "rel", "eb": 1e-4}
    assert M.config_fingerprint(cfg) == RM.config_fingerprint(cfg)
    assert (M.META_KEY, M.MANIFEST_SCHEMA, M.STAGES) == \
        (RM.META_KEY, RM.MANIFEST_SCHEMA, RM.STAGES)
    stats = {"n_records": 2, "raw_bytes": 10, "stored_bytes": 4,
             "compress_s": 0.5, "write_s": 0.25, "wall_s": 0.6}
    assert M.build_manifest(stats=stats, config=cfg) == \
        RM.build_manifest(stats=stats, config=cfg)
    assert M.config_fingerprint(CEAZConfig()) != \
        RM.config_fingerprint(RConfig())


def test_filewrite_payloads_equal_reference(tmp_path):
    """parallel_compressed_write: the records (index rows and payloads)
    equal the reference's dump, fused and staged; the telemetry in the
    footer differs only in its timings and fingerprint."""
    shards = [F.nyx_proxy(seed=s) for s in range(3)]
    for kw, rkw in (({}, {}), (dict(use_fused=False),
                                dict(use_fused=False))):
        ref = RCEAZ(RConfig(mode="rel", eb=1e-4, use_fused=True,
                            backend="jax"))
        d_p, d_r = tmp_path / f"p{len(kw)}", tmp_path / f"r{len(kw)}"
        st = FW.parallel_compressed_write(str(d_p), shards, comp=_port(),
                                          fsync=False, **kw)
        RFW.parallel_compressed_write(str(d_r), shards, comp=ref,
                                      fsync=False, **rkw)
        with E.StreamReader(str(d_p / FW.DUMP_NAME)) as a, \
                RE.StreamReader(str(d_r / RFW.DUMP_NAME)) as b:
            assert a.records == b.records
            assert [a.payload(i) for i in range(len(a))] == \
                [b.payload(i) for i in range(len(b))]
            assert {k: v for k, v in a.meta.items() if k != M.META_KEY} \
                == {k: v for k, v in b.meta.items() if k != RM.META_KEY}
        assert st["raw_bytes"] == sum(s.nbytes for s in shards)
        assert st["stored_bytes"] < st["raw_bytes"]
        assert st["serialize_s"] > 0 and st["ratio"] > 1
        back = FW.parallel_read(str(d_p), device="cpu")
        for a, b in zip(back, shards):
            assert np.abs(a - b).max() <= _bound(b)


def test_entry_points_default_to_the_card(tmp_path, shards):
    """Every new entry point builds its facade on the card by default and
    raises without one; nothing is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    p = str(tmp_path / FW.DUMP_NAME)
    E.write_stream(p, shards[:1], _port(), fsync=False)
    calls = [lambda: E.write_stream(str(tmp_path / "x.ceazs"), shards[:1]),
             lambda: E.ceaz_compress_fn(),
             lambda: E.read_stream_arrays(p),
             lambda: E.AsyncDecodeReadEngine(p),
             lambda: FW.parallel_compressed_write(str(tmp_path / "d"),
                                                  shards[:1]),
             lambda: FW.parallel_read(str(tmp_path))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert os.listdir(tmp_path) == [FW.DUMP_NAME]


def test_facade_error_on_compress_thread_aborts_stream(tmp_path):
    """A shard the facade refuses fails on the compress thread; the
    stream is aborted and nothing is left under the final name or as a
    temp file."""
    bad = [F.nyx_proxy(seed=0), np.zeros(100, np.int32)]
    path = tmp_path / "bad.ceazs"
    for sync in (False, True):
        with pytest.raises((RuntimeError, TypeError), match="float data"):
            E.write_stream(str(path), bad, _port(), fsync=False, group=1,
                           sync=sync)
        assert os.listdir(tmp_path) == []


def test_launch_counts_are_exact_across_threads():
    """The write engine launches from its compress thread: the launch
    counters must not lose an update to a concurrent one."""
    import sys
    from repro_torch.kernels import dispatch
    saved = dict(dispatch.launches())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        dispatch.reset_launches()
        workers = [threading.Thread(target=lambda: [
            dispatch.count_launch("stress") for _ in range(2000)])
            for _ in range(4 * (os.cpu_count() or 1))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        assert dispatch.launches() == {"stress": 2000 * len(workers)}
    finally:
        sys.setswitchinterval(old)
        dispatch.reset_launches()
        for k, n in saved.items():
            for _ in range(n):
                dispatch.count_launch(k)


def test_report_module_runs_as_a_script(tmp_path):
    import subprocess
    import sys
    path = tmp_path / "c.ceazs"
    _write_throttled(path, n=2)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                          str(path), "--records", "1"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "slowest records" in res.stdout and "top 1 of 2" in res.stdout


# -- the reference's engine cases, against the port ---------------------------

def test_async_byte_identical_to_sync(tmp_path, shards):
    _write(tmp_path / "async.ceazs", shards, sync=False, telemetry=False)
    _write(tmp_path / "sync.ceazs", shards, sync=True, telemetry=False)
    assert (tmp_path / "async.ceazs").read_bytes() \
        == (tmp_path / "sync.ceazs").read_bytes()


def test_grouping_does_not_change_bytes(tmp_path, shards):
    _write(tmp_path / "g1.ceazs", shards, group=1, telemetry=False)
    _write(tmp_path / "g4.ceazs", shards, group=4, telemetry=False)
    assert (tmp_path / "g1.ceazs").read_bytes() \
        == (tmp_path / "g4.ceazs").read_bytes()


def test_round_trip_within_bound(tmp_path, shards):
    _write(tmp_path / "s.ceazs", shards)
    back = E.read_stream_arrays(str(tmp_path / "s.ceazs"), device="cpu")
    for a, b in zip(back, shards):
        assert np.abs(a - b).max() <= _bound(b)


def test_stats_account_stages(tmp_path, shards):
    st = _write(tmp_path / "s.ceazs", shards)
    assert st.n_records == len(shards)
    assert st.raw_bytes == sum(s.nbytes for s in shards)
    assert st.stored_bytes < st.raw_bytes
    assert st.wall_s > 0 and st.compress_s > 0 and st.write_s > 0


def _good_stream(tmp_path):
    path = str(tmp_path / "good.ceazs")
    w = E.StreamWriter(path, fsync=False)
    for i, payload in enumerate([b"alpha" * 40, b"bravo" * 55,
                                 b"charlie" * 33]):
        w.append(f"k{i}", payload, {"codec": "raw"})
    w.close()
    return path


def test_truncated_file_fails_loudly(tmp_path):
    path = _good_stream(tmp_path)
    data = open(path, "rb").read()
    for cut in (10, len(data) // 2, len(data) - 7):
        with open(path, "wb") as f:
            f.write(data[:cut])
        with pytest.raises(E.StreamCorruptionError):
            E.StreamReader(path)


def test_corrupted_footer_checksum_fails_loudly(tmp_path):
    path = _good_stream(tmp_path)
    data = bytearray(open(path, "rb").read())
    foot_off, foot_len, _, _ = E.TRAILER.unpack(data[-E.TRAILER.size:])
    data[foot_off + foot_len // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(E.StreamCorruptionError, match="footer checksum"):
        E.StreamReader(path)


def test_corrupted_payload_fails_loudly(tmp_path):
    path = _good_stream(tmp_path)
    with E.StreamReader(path) as r:
        off = r.records[1]["offset"] + E.RECORD_HEADER.size + 3
    data = bytearray(open(path, "rb").read())
    data[off] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with E.StreamReader(path) as r:             # the index is intact
        with pytest.raises(E.StreamCorruptionError, match="checksum"):
            r.payload(1)


def test_out_of_order_commit_fails_loudly(tmp_path):
    path = _good_stream(tmp_path)
    with E.StreamReader(path) as r:
        off0, off1 = r.records[0]["offset"], r.records[1]["offset"]
    data = bytearray(open(path, "rb").read())
    struct.pack_into("<I", data, off0 + 4, 1)
    struct.pack_into("<I", data, off1 + 4, 0)
    open(path, "wb").write(bytes(data))
    with E.StreamReader(path) as r:
        with pytest.raises(E.StreamCorruptionError, match="out-of-order"):
            r.payload(0)


def _rewrite_footer(path, mutate):
    """Rewrite the stream footer through `mutate(doc)` and restamp the
    trailer (length + crc) so only the JSON content differs."""
    with E.StreamReader(path) as r:
        foot_off = r.records[-1]["offset"] + E.RECORD_HEADER.size \
            + r.records[-1]["nbytes"]
    data = bytearray(open(path, "rb").read())
    _, foot_len, _, _ = E.TRAILER.unpack(data[-E.TRAILER.size:])
    doc = json.loads(bytes(data[foot_off:foot_off + foot_len]))
    mutate(doc)
    footer = json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()
    data = data[:foot_off] + footer + E.TRAILER.pack(
        foot_off, len(footer), zlib.crc32(footer) & 0xFFFFFFFF, E.END_MAGIC)
    open(path, "wb").write(bytes(data))


def test_index_seq_permutation_fails_at_open(tmp_path):
    path = _good_stream(tmp_path)

    def swap(doc):
        doc["records"][0], doc["records"][1] = (doc["records"][1],
                                                doc["records"][0])
    _rewrite_footer(path, swap)
    with pytest.raises(E.StreamCorruptionError, match="out-of-order"):
        E.StreamReader(path)


def test_compress_error_propagates_and_no_file(tmp_path):
    path = str(tmp_path / "boom.ceazs")

    def bad_compress(keys, items):
        raise ValueError("compressor exploded")

    eng = E.AsyncCompressWriteEngine(path, bad_compress, fsync=False)
    eng.submit("a", np.zeros(8, np.float32))
    with pytest.raises(RuntimeError, match="compressor exploded"):
        for _ in range(64):
            eng.submit("b", np.zeros(8, np.float32))
        eng.close()
    assert not os.path.exists(path)


def test_backpressure_bounds_inflight(tmp_path):
    inflight, peak = [0], [0]
    lock = threading.Lock()

    def compress(keys, items):
        with lock:
            inflight[0] += 1
            peak[0] = max(peak[0], inflight[0])
        return [np.asarray(i).tobytes() for i in items]

    def slow_serialize(obj):
        time.sleep(0.02)
        with lock:
            inflight[0] -= 1
        return obj, {"codec": "raw"}

    eng = E.AsyncCompressWriteEngine(
        str(tmp_path / "bp.ceazs"), compress, slow_serialize,
        max_inflight=2, writers=1, fsync=False)
    with eng:
        for i in range(16):
            eng.submit(f"k{i}", np.full(4, i, np.float32))
    assert peak[0] <= 2 * 2 + 1, peak[0]
    with E.StreamReader(str(tmp_path / "bp.ceazs")) as r:
        assert len(r) == 16


def test_read_pipeline_matches_sync(tmp_path, shards):
    path = str(tmp_path / "s.ceazs")
    _write(path, shards)
    a = E.read_stream_arrays(path, device="cpu")
    b = E.read_stream_arrays(path, sync=True, device="cpu")
    assert len(a) == len(b) == len(shards)
    for x, y, s in zip(a, b, shards):
        assert np.array_equal(x, y)
        assert np.abs(x - s).max() <= _bound(s)


def test_read_pipeline_group_invariance(tmp_path, shards):
    path = str(tmp_path / "s.ceazs")
    _write(path, shards)
    want = E.read_stream_arrays(path, group=2, device="cpu")
    for g in (1, 3, 16):
        for x, y in zip(E.read_stream_arrays(path, group=g, device="cpu"),
                        want):
            assert np.array_equal(x, y)


def test_read_pipeline_stats(tmp_path, shards):
    path = str(tmp_path / "s.ceazs")
    _write(path, shards)
    with E.AsyncDecodeReadEngine(path, device="cpu") as eng:
        assert len(eng) == len(shards)
        out = eng.objects()
    assert len(out) == len(shards)
    st = eng.stats
    assert st.n_records == len(shards)
    assert st.raw_bytes == sum(s.nbytes for s in shards)
    assert st.stored_bytes < st.raw_bytes
    assert st.wall_s > 0 and st.read_s > 0 and st.decode_s > 0


def _flip(path, record, rel_off):
    with E.StreamReader(path) as r:
        off = r.records[record]["offset"] + E.RECORD_HEADER.size + rel_off
    data = bytearray(open(path, "rb").read())
    data[off] ^= 0xFF
    open(path, "wb").write(bytes(data))


def test_read_pipeline_surfaces_corruption(tmp_path, shards):
    path = str(tmp_path / "s.ceazs")
    _write(path, shards)
    _flip(path, 2, 5)
    with pytest.raises(E.StreamCorruptionError, match="checksum"):
        E.read_stream_arrays(path, device="cpu")


def test_read_seq_random_access(tmp_path, shards):
    path = str(tmp_path / "s.ceazs")
    _write(path, shards)
    comp = _port()
    with E.StreamReader(path) as r:
        rec = comp.decompress(r.read_seq(2))
        assert np.abs(rec - shards[2]).max() <= _bound(shards[2])
        assert r.seq_of(r.records[1]["key"]) == 1
        assert np.array_equal(comp.decompress(r.read_key(r.records[1]["key"])),
                              comp.decompress(r.read_seq(1)))
        with pytest.raises(IndexError):
            r.read_seq(len(shards))
        with pytest.raises(KeyError):
            r.seq_of("no_such_key")


def test_random_access_out_of_range_and_missing_key(tmp_path):
    path = _good_stream(tmp_path)
    with E.StreamReader(path) as r:
        for bad in (-1, len(r), len(r) + 7):
            with pytest.raises(IndexError, match="out of range"):
                r.read_seq(bad)
        with pytest.raises(KeyError) as ei:
            r.seq_of("no_such_key")
        assert ei.value.__suppress_context__
        assert "no_such_key" in str(ei.value)
        with pytest.raises(KeyError):
            r.read_key("no_such_key")


def test_duplicate_record_key_fails_at_open(tmp_path):
    path = str(tmp_path / "dup.ceazs")
    w = E.StreamWriter(path, fsync=False)
    w.append("k", b"alpha" * 8, {"codec": "raw"})
    w.append("unique", b"bravo" * 8, {"codec": "raw"})
    w.append("k", b"charlie" * 8, {"codec": "raw"})
    w.close()
    with pytest.raises(E.StreamCorruptionError,
                       match="duplicate record key"):
        E.StreamReader(path)


def test_footer_index_truncation_fails_at_open(tmp_path):
    path = _good_stream(tmp_path)
    data = open(path, "rb").read()
    foot_off, foot_len, _, _ = E.TRAILER.unpack(data[-E.TRAILER.size:])
    for cut in (foot_off, foot_off + foot_len // 2,
                len(data) - E.TRAILER.size // 2):
        open(path, "wb").write(data[:cut])
        with pytest.raises(E.StreamCorruptionError):
            E.StreamReader(path)


def test_read_engine_abandoned_close_is_prompt(tmp_path, shards):
    path = str(tmp_path / "s.ceazs")
    _write(path, shards)
    eng = E.AsyncDecodeReadEngine(path, group=1, max_inflight=1,
                                  device="cpu")
    time.sleep(0.2)                 # let the prefetcher fill the queue
    t0 = time.perf_counter()
    eng.close()                     # nothing consumed
    assert time.perf_counter() - t0 < 2.0
    assert not eng._prefetcher.is_alive()


def test_read_engine_is_one_shot(tmp_path, shards):
    path = str(tmp_path / "s.ceazs")
    _write(path, shards)
    with E.AsyncDecodeReadEngine(path, device="cpu") as eng:
        assert len(eng.objects()) == len(shards)
        with pytest.raises(RuntimeError, match="one-shot"):
            list(eng)


def test_stream_records_block_size_and_reader_uses_it(tmp_path, shards):
    path = str(tmp_path / "bs.ceazs")
    E.write_stream(path, shards, _port(block_size=1024), fsync=False)
    with E.StreamReader(path) as r:
        assert r.meta["block_size"] == 1024
    back = E.read_stream_arrays(path, device="cpu")
    for a, b in zip(back, shards):
        assert np.abs(a - b).max() <= _bound(b)
    with pytest.raises(ValueError, match="block_size"):
        E.read_stream_arrays(path, _port(block_size=4096))


def test_legacy_footer_without_block_size_warns_and_decodes(tmp_path,
                                                           shards):
    path = str(tmp_path / "legacy.ceazs")
    comp = _port()
    eng = E.AsyncCompressWriteEngine(path, E.ceaz_compress_fn(comp),
                                     fsync=False)
    with eng:
        for i, s in enumerate(shards):
            eng.submit(f"shard_{i}", s)
    with E.StreamReader(path) as r:
        assert "block_size" not in r.meta
    with pytest.warns(UserWarning, match="block_size"):
        back = E.read_stream_arrays(path, device="cpu")
    for a, b in zip(back, shards):
        assert np.abs(a - b).max() <= _bound(b)
    for a, b in zip(E.read_stream_arrays(path, comp), back):
        assert np.array_equal(a, b)


def test_parallel_read_self_configures_block_size(tmp_path, shards):
    FW.parallel_compressed_write(str(tmp_path), shards,
                                 comp=_port(block_size=1024), fsync=False)
    back = FW.parallel_read(str(tmp_path), device="cpu")
    for a, b in zip(back, shards):
        assert np.abs(a - b).max() <= _bound(b)


def test_bank_stream_self_configures_and_checks_records(tmp_path):
    """A bank-mode stream carries its bank in the footer; the default
    reader registers it and cross-checks every record's bank fields (a
    tampered delta or id raises, never decodes)."""
    shards = _hacc()
    path = str(tmp_path / "bank.ceazs")
    E.write_stream(path, shards, _port(codebook="bank"), fsync=False)
    with E.StreamReader(path) as r:
        assert "codebook_bank" in r.meta
        assert all(rec["bank_id"] and min(rec["bank_delta"]) >= 0
                   for rec in r.records)
    for a, b in zip(E.read_stream_arrays(path, device="cpu"), shards):
        assert np.abs(a - b).max() <= _bound(b)
    for field, value, what in (("bank_delta", [99], "bank_delta"),
                               ("bank_id", "nope", "unresolvable")):
        bad = str(tmp_path / f"{field}.ceazs")
        open(bad, "wb").write(open(path, "rb").read())
        _rewrite_footer(bad, lambda d: d["records"][0].update(
            {field: value}))
        with pytest.raises(E.StreamCorruptionError, match=what):
            E.read_stream_arrays(bad, device="cpu")
    _rewrite_footer(path, lambda d: d["meta"]["codebook_bank"].update(
        id="forged"))
    with pytest.raises(E.StreamCorruptionError, match="codebook_bank"):
        E.AsyncDecodeReadEngine(path, device="cpu")


def _ceaz_stream(tmp_path):
    """A real stream whose records ship their codebooks (adaptive=False
    rebuilds per chunk) — the fuzz target, as chip_smoke.py's W.fuzz
    writes it on the card."""
    path = str(tmp_path / "fuzz.ceazs")
    shards = [_walk(6000, 4 + i) for i in range(3)]
    E.write_stream(path, shards, _port(**stream_cases.FUZZ_KW), fsync=False)
    return path, shards


def test_fuzz_bit_flip_in_codebook_bytes(tmp_path):
    path, shards = _ceaz_stream(tmp_path)
    with E.StreamReader(path) as r:
        rec = r.records[1]
        payload = r.payload(1)
    c = E.deserialize_payload(payload, rec)
    lengths = c.chunks[0].codebook_lengths
    assert lengths is not None
    pos = payload.find(lengths.tobytes())
    assert pos > 0
    base = rec["offset"] + E.RECORD_HEADER.size
    data = bytearray(open(path, "rb").read())
    for bit in (0, 3, 7):
        fuzzed = bytearray(data)
        fuzzed[base + pos + bit * 11] ^= 1 << bit
        open(path, "wb").write(bytes(fuzzed))
        with E.StreamReader(path) as rr:
            with pytest.raises(E.StreamCorruptionError, match="checksum"):
                rr.payload(1)
    open(path, "wb").write(bytes(data))
    assert len(E.read_stream_arrays(path, device="cpu")) == len(shards)


def _section_boundaries(path):
    with E.StreamReader(path) as r:
        records = list(r.records)
    data = open(path, "rb").read()
    foot_off, foot_len, _, _ = E.TRAILER.unpack(data[-E.TRAILER.size:])
    cuts = {len(E.STREAM_MAGIC)}
    for rec in records:
        cuts.add(rec["offset"] + E.RECORD_HEADER.size)
        cuts.add(rec["offset"] + E.RECORD_HEADER.size + rec["nbytes"])
    cuts |= {foot_off, foot_off + foot_len // 2, foot_off + foot_len,
             len(data) - len(E.END_MAGIC)}
    return sorted(c for c in cuts if c < len(data)), data


def test_fuzz_truncation_at_every_section_boundary(tmp_path):
    path, shards = _ceaz_stream(tmp_path)
    cuts, data = _section_boundaries(path)
    assert len(cuts) >= 10
    for cut in cuts:
        open(path, "wb").write(data[:cut])
        with pytest.raises(E.StreamCorruptionError):
            with E.StreamReader(path) as r:
                for i in range(len(r.records)):
                    E.deserialize_payload(r.payload(i), r.records[i])
    open(path, "wb").write(data)
    for a, b in zip(E.read_stream_arrays(path, device="cpu"), shards):
        assert np.abs(a - b).max() <= _bound(b)


def _decode_impl_comps():
    """The port's three decode routes: staged (host table walk), split
    (the `hufdec` walk) and the decode megakernel."""
    base = stream_cases.FUZZ_KW
    return [("staged", _port(use_fused=False, **base)),
            ("split", _port(decode_megakernel="split", **base)),
            ("mega", _port(decode_megakernel="mega", **base))]


def _decode_verdicts(path):
    out = []
    for name, comp in _decode_impl_comps():
        try:
            arrs = E.read_stream_arrays(path, comp, sync=True)
            out.append((name, "ok", tuple(a.tobytes() for a in arrs)))
        except E.StreamCorruptionError:
            out.append((name, "corrupt", None))
    return out


def test_decode_differential_fuzz_fence(tmp_path):
    """Every stream-level corpus mutation gets the same verdict,
    'corrupt', from the port's staged, split and mega routes, and the
    pristine stream decodes to the same bytes on all three (and to the
    reference's decode of the same stream)."""
    path, shards = _ceaz_stream(tmp_path)
    with E.StreamReader(path) as r:
        records = list(r.records)
    data = open(path, "rb").read()
    clean = _decode_verdicts(path)
    assert all(v == "ok" for _, v, _ in clean), clean
    assert len({b for _, _, b in clean}) == 1
    ref = RE.read_stream_arrays(path, RCEAZ(RConfig(
        mode="rel", eb=1e-4, use_fused=True, adaptive=False,
        chunk_bytes=1 << 13)), sync=True)
    assert clean[0][2] == tuple(a.tobytes() for a in ref)
    cases = stream_cases.corpus_cases(len(records))
    assert len(cases) == 22
    for case in cases:
        open(path, "wb").write(
            stream_cases.apply_corpus_case(data, records, case))
        verdicts = _decode_verdicts(path)
        assert len({(v, b) for _, v, b in verdicts}) == 1, (case, verdicts)
        assert verdicts[0][1] == "corrupt", (case, verdicts)
    open(path, "wb").write(data)
    assert len(E.read_stream_arrays(path, device="cpu")) == len(shards)


def test_group_decode_failure_names_the_record(tmp_path):
    path = str(tmp_path / "named.ceazs")
    shards = [_walk(n, 7) for n in (5000, 7777, 6000)]
    comp = _port()
    E.write_stream(path, shards, comp, fsync=False)

    class PoisonedComp:
        def decompress_batch(self, objs):
            if any(int(o.n_values) == 7777 for o in objs):
                raise ValueError("device pass exploded")
            return comp.decompress_batch(objs)

    with pytest.raises(ValueError, match=r"record seq=1\b") as ei:
        E.read_stream_arrays(path, PoisonedComp(), group=8, sync=True)
    assert ei.value.__cause__ is not None


def test_write_engine_wall_s_set_once_on_error_path(tmp_path):
    def bad_compress(keys, items):
        raise ValueError("compressor exploded")

    eng = E.AsyncCompressWriteEngine(str(tmp_path / "werr.ceazs"),
                                     bad_compress, fsync=False)
    eng.submit("a", np.zeros(8, np.float32))
    with pytest.raises(RuntimeError, match="compressor exploded"):
        for _ in range(64):
            eng.submit("b", np.zeros(8, np.float32))
        eng.close()
    w = eng.stats.wall_s
    assert w > 0 and eng.stats.wall_s == w
    eng.abort()
    assert eng.stats.wall_s == w


def test_write_engine_wall_s_idempotent_on_close(tmp_path):
    eng = E.AsyncCompressWriteEngine(
        str(tmp_path / "wok.ceazs"),
        lambda keys, items: [np.asarray(i).tobytes() for i in items],
        fsync=False)
    eng.submit("a", np.zeros(8, np.float32))
    w = eng.close().wall_s
    assert w > 0
    eng.close()
    assert eng.stats.wall_s == w


def test_read_engine_wall_s_set_on_error_path(tmp_path, shards):
    path = str(tmp_path / "rerr.ceazs")
    _write(path, shards)
    _flip(path, 1, 5)
    eng = E.AsyncDecodeReadEngine(path, device="cpu")
    with pytest.raises(E.StreamCorruptionError):
        eng.objects()
    eng.close()
    w = eng.stats.wall_s
    assert w > 0 and eng.stats.wall_s == w


def test_footer_unknown_meta_keys_are_ignored(tmp_path, shards):
    path = str(tmp_path / "future.ceazs")
    _write(path, shards)
    want = E.read_stream_arrays(path, device="cpu")
    future = {"schema": 999, "hyperdrive": {"warp": [9, 9, 9]},
              "stages": "reshaped-beyond-recognition"}

    def mutate(doc):
        doc["meta"]["telemetry"] = future
        doc["meta"]["from_the_future"] = {"nested": ["junk", 42]}
        doc["not_a_known_top_level_key"] = True

    _rewrite_footer(path, mutate)
    with E.StreamReader(path) as r:
        assert r.meta["from_the_future"] == {"nested": ["junk", 42]}
        assert r.telemetry() == future
    for a, b in zip(E.read_stream_arrays(path, device="cpu"), want):
        assert np.array_equal(a, b)


# -- the reference's manifest and report cases, against the port --------------

def test_config_fingerprint_stable_and_field_sensitive():
    a = CEAZConfig(mode="rel", eb=1e-4)
    b = CEAZConfig(mode="rel", eb=1e-4)
    c = CEAZConfig(mode="rel", eb=1e-3)
    assert M.config_fingerprint(a) == M.config_fingerprint(b)
    assert M.config_fingerprint(a) != M.config_fingerprint(c)
    assert M.config_fingerprint(a) != \
        M.config_fingerprint(CEAZConfig(device="cpu"))
    assert len(M.config_fingerprint(a)) == 12
    assert M.config_fingerprint({"k": 1}) != M.config_fingerprint({"k": 2})


def test_build_manifest_zero_stats_is_all_zero():
    man = M.build_manifest(stats={})
    assert man["schema"] == M.MANIFEST_SCHEMA
    assert man["summary"] == {"n_records": 0, "raw_bytes": 0,
                              "stored_bytes": 0, "ratio": 0.0,
                              "overlap_efficiency": 0.0}
    rows = M.stage_rows(man)
    assert [r["stage"] for r in rows] == ["compress", "serialize", "write"]
    assert all(r["seconds"] == 0.0 and r["share"] == 0.0 for r in rows)


def test_from_meta_is_lenient():
    assert M.from_meta(None) is None
    assert M.from_meta({}) is None
    assert M.from_meta({"telemetry": "not-a-dict"}) is None
    future = {"schema": 99, "surprise": [1, 2]}
    assert M.from_meta({"telemetry": future}) == future


@pytest.fixture()
def tracer():
    ot.disable()
    t = ot.enable(save_at_exit=False)
    t.clear()
    yield t
    ot.disable()


def _stub_compress(keys, items):
    time.sleep(0.003)                      # stand-in device pass
    return [np.asarray(i).tobytes() for i in items]


def _write_throttled(path, n=8, telemetry=True):
    """n x 100KB records against an emulated ~2MB/s store: commit of
    group i provably overlaps compress of group i+1."""
    eng = E.AsyncCompressWriteEngine(
        str(path), _stub_compress, fsync=False, emulate_bps=2e6,
        config={"kind": "stub"}, telemetry=telemetry)
    with eng:
        for i in range(n):
            eng.submit(f"k{i}", np.full(25_000, i, np.float32))
    return eng


def _intervals(evs, name):
    return [(e["ts"], e["ts"] + e["dur"], e["tid"])
            for e in evs if e["name"] == name]


def test_traced_write_engine_shows_overlap(tracer, tmp_path):
    _write_throttled(tmp_path / "o.ceazs")
    evs = tracer.events()
    compress = _intervals(evs, "engine.compress")
    commit = _intervals(evs, "engine.commit")
    assert compress and commit
    assert any(c[2] != w[2] and max(c[0], w[0]) < min(c[1], w[1])
               for c in compress for w in commit), \
        "no compress span overlapped any commit span"
    doc = json.loads(json.dumps(tracer.to_chrome()))
    assert any(e["name"] == "engine.commit" for e in doc["traceEvents"])


def test_traced_read_engine_spans(tracer, tmp_path):
    path = tmp_path / "r.ceazs"
    rng = np.random.default_rng(3)
    E.write_stream(str(path), [rng.normal(size=(64, 64)).astype(np.float32)
                               for _ in range(4)], _port(), fsync=False)
    tracer.clear()
    with E.AsyncDecodeReadEngine(str(path), device="cpu") as eng:
        assert len(eng.objects()) == 4
    names = {e["name"] for e in tracer.events()}
    assert {"reader.prefetch", "reader.decode_group",
            "reader.queue_wait"} <= names


def test_manifest_round_trips_bit_exact(tmp_path):
    eng = _write_throttled(tmp_path / "m.ceazs", n=4)
    assert eng.manifest is not None
    with E.StreamReader(str(tmp_path / "m.ceazs")) as r:
        embedded = r.telemetry()
    assert embedded == eng.manifest
    assert embedded["fingerprint"] == M.config_fingerprint({"kind": "stub"})
    assert embedded["summary"]["n_records"] == 4
    assert len(embedded["records"]) == 4
    assert all(r["write_s"] > 0 for r in embedded["records"])
    assert embedded["stages"]["wall_s"] > 0


def test_telemetry_off_leaves_footer_clean(tmp_path):
    eng = _write_throttled(tmp_path / "q.ceazs", n=2, telemetry=False)
    assert eng.manifest is None
    with E.StreamReader(str(tmp_path / "q.ceazs")) as r:
        assert r.telemetry() is None
        assert M.META_KEY not in r.meta


def test_queue_depth_gauges_and_corruption_counter(tmp_path):
    _write_throttled(tmp_path / "g.ceazs", n=2)
    snap = om.snapshot()
    assert om.QUEUE_DEPTH + '{queue="compress"}' in snap
    before = snap.get(om.CORRUPTION, 0)
    with pytest.raises(E.StreamCorruptionError):
        E.StreamReader(str(tmp_path / "nonexistent.ceazs"))
    assert om.snapshot()[om.CORRUPTION] == before + 1


def test_report_cli_prints_stage_rows(tmp_path, capsys):
    path = tmp_path / "c.ceazs"
    _write_throttled(path, n=3)
    assert report.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "stage" in out and "share" in out
    for stage in ("compress", "serialize", "write", "wall"):
        assert stage in out
    assert "slowest records" in out
    assert report.main([str(path), "--json"]) == 0
    man = json.loads(capsys.readouterr().out)
    assert man["schema"] == M.MANIFEST_SCHEMA


def test_report_cli_exit_codes(tmp_path, capsys):
    assert report.main([]) == 2                       # usage
    assert report.main(["x", "--records"]) == 2       # bad --records
    no_tel = tmp_path / "n.ceazs"
    _write_throttled(no_tel, n=1, telemetry=False)
    assert report.main([str(no_tel)]) == 3            # valid, no manifest
    bad = tmp_path / "bad.ceazs"
    bad.write_bytes(b"not a stream at all")
    assert report.main([str(bad)]) == 1               # corrupt
    capsys.readouterr()
