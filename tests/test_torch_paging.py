"""The port's decode-on-demand parameter store (``repro_torch/serve/
paging.py``) on the CPU: the reference's ``tests/test_paging.py`` cases,
built on ``PagedParamStore`` directly over a checkpoint stream, and the
paged bfloat16 leaves against the reference's store over the same stream,
compared as their 16 bits.
"""
import os
import random
import threading

import numpy as np
import pytest
import torch

from repro.runtime.sharding import ShardingPlan as RPlan
from repro.serve.paging import PagedParamStore as RStore
from repro_torch.checkpoint import ckpt as C
from repro_torch.io import engine as E
from repro_torch.launch import mesh as LM
from repro_torch.obs import metrics as om
from repro_torch.obs import trace as ot
from repro_torch.runtime import sharding as S
from repro_torch.serve import PagedParamStore


def _state(seed=0, shift=0.0):
    """A small tree with PARAM_RULES-shaped keys; every float leaf but
    `norm` is big enough to ride the ceaz codec (norm is raw npy)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) + shift).astype(np.float32)
    return {"params": {"embed": {"table": mk(512, 64)},
                       "layers": [{"mlp": {"wi": mk(64, 128),
                                           "wo": mk(128, 64)}}
                                  for _ in range(4)],
                       "norm": np.ones((64,), np.float32) + shift},
            "step": np.int32(1)}


def _stream(d, step):
    return os.path.join(d, f"step_{step:08d}", C.LEAVES_STREAM)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    C.save_checkpoint(d, _state(seed=0), 1, device="cpu")
    C.save_checkpoint(d, _state(seed=0, shift=3.0), 2, device="cpu")
    return d, _stream(d, 1), _stream(d, 2)


@pytest.fixture(scope="module")
def raw_streams(tmp_path_factory):
    """The two states as raw (npy) streams: the stress test below pages
    from 4 threads, where each plain-walk decode pass on the CPU takes
    ~10 s (the ceaz streams' generations are held by the pin test)."""
    d = str(tmp_path_factory.mktemp("ckpt_raw"))
    raw = C.CheckpointConfig(mode="raw")
    C.save_checkpoint(d, _state(seed=0), 1, cfg=raw, device="cpu")
    C.save_checkpoint(d, _state(seed=0, shift=3.0), 2, cfg=raw,
                      device="cpu")
    return d, _stream(d, 1), _stream(d, 2)


def _store(path, **kw):
    kw.setdefault("prefix", "params/")
    return PagedParamStore(path, device="cpu", **kw)


def _u16(t):
    return t.view(torch.int16).numpy().tobytes()


def _truth(stream):
    with _store(stream) as st, st.pin() as pin:
        return {k: _u16(v) for k, v in pin.get_many(pin.keys()).items()}


def test_paged_bits_match_reference_and_full_restore(streams):
    d, s1, _ = streams
    with _store(s1) as store, store.pin() as pin, \
            RStore(s1, plan=RPlan(mesh=None), prefix="params/") as rstore, \
            rstore.pin() as rpin:
        assert pin.keys() == rpin.keys()
        got = pin.get_many(pin.keys())
        ref = rpin.get_many(rpin.keys())
        tree = pin.params()
    full, _ = C.restore_checkpoint(d, step=1, device="cpu")
    flat = dict(C.tree_items(full["params"]))
    for k, v in got.items():
        assert v.dtype == torch.bfloat16 and v.device.type == "cpu", k
        r = np.asarray(ref[k])
        assert str(r.dtype) == "bfloat16" and tuple(v.shape) == r.shape, k
        assert _u16(v) == r.view(np.int16).tobytes(), k
        cast = torch.from_numpy(flat[k[len("params/"):]]).to(torch.bfloat16)
        assert torch.equal(v.view(torch.int16), cast.view(torch.int16)), k
    assert set(tree) == {"embed", "layers", "norm"}
    assert len(tree["layers"]) == 4
    assert torch.equal(tree["layers"][2]["mlp"]["wi"],
                       got["params/layers/2/mlp/wi"])


def test_placement_dtype_and_device(streams):
    _, s1, _ = streams
    plan = S.make_plan(LM.make_mesh((1, 1), ("data", "model"),
                                    devices=["cpu"]))
    with _store(s1, plan=plan) as a, _store(s1) as b, \
            _store(s1, dtype=None, prefix=None) as raw:
        with a.pin() as pa, b.pin() as pb, raw.pin() as pr:
            ga, gb = pa.get_many(pa.keys()), pb.get_many(pb.keys())
            for k in pa.keys():
                assert torch.equal(ga[k], gb[k]), k
            assert pr.get("params/norm").dtype == torch.float32
            step = pr.get("step")
            assert step.dtype == torch.int32 and step.shape == ()  # as is
            assert "step" in pr.keys() and "step" not in pa.keys()
    two = S.make_plan(LM.make_mesh((2, 1), ("data", "model"),
                                   devices=["cuda:0", "cuda:1"]))
    with _store(s1, plan=two) as st, st.pin() as pin:
        with pytest.raises(ValueError, match="one process a position"):
            pin.get("params/norm")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedParamStore(s1)


def test_lru_respects_byte_budget_under_random_access(streams):
    _, s1, _ = streams
    budget = 40_000               # room for ~2 of the 8192-value bf16 leaves
    ev0 = om.DEFAULT.counter(om.PAGE_EVICTIONS).value()
    with _store(s1, cache_bytes=budget) as store:
        keys = [k for k in store.keys() if "mlp" in k]
        rng = np.random.default_rng(5)
        with store.pin() as pin:
            for k in rng.choice(keys, size=24):
                pin.get(str(k))
                assert store.cache_resident_bytes <= budget
        assert om.DEFAULT.counter(om.PAGE_EVICTIONS).value() > ev0
        assert 0 < store.cache_resident_bytes <= budget
        assert store.cache_budget_bytes == budget


def test_oversized_leaf_is_served_but_not_retained(streams):
    _, s1, _ = streams
    with _store(s1, cache_bytes=100) as store:
        with store.pin() as pin:
            leaf = pin.get("params/embed/table")
        assert tuple(leaf.shape) == (512, 64)
        assert store.cache_resident_bytes == 0


def test_page_counters_gauge_and_spans(streams):
    _, s1, s2 = streams
    h0 = om.DEFAULT.counter(om.PAGE_HITS).value()
    m0 = om.DEFAULT.counter(om.PAGE_MISSES).value()
    tr = ot.enable(save_at_exit=False)
    tr.clear()
    try:
        with _store(s1) as store:
            with store.pin() as pin:
                pin.get("params/norm")           # cold: miss
                pin.get("params/norm")           # warm: hit
            assert om.DEFAULT.counter(om.PAGE_MISSES).value() == m0 + 1
            assert om.DEFAULT.counter(om.PAGE_HITS).value() == h0 + 1
            assert om.DEFAULT.gauge(om.PAGE_CACHE_BYTES).value() \
                == store.cache_resident_bytes == 64 * 2
            store.swap(s2, warm=["params/norm"])
        names = [e["name"] for e in tr.events()]
    finally:
        ot.disable()
    assert names.count("serve.swap") == 1
    assert names.count("serve.page") == 2


def test_hot_swap_pins_never_see_mixed_generations(raw_streams):
    _, s1, s2 = raw_streams
    truth = [_truth(s1), _truth(s2)]
    assert truth[0] != truth[1]
    store = _store(s1, cache_bytes=60_000)
    stop = threading.Event()
    errors = []

    def reader():
        rnd = random.Random(threading.get_ident())
        while not stop.is_set():
            with store.pin() as pin:
                keys = pin.keys()
                rnd.shuffle(keys)
                got = {k: _u16(v) for k, v in pin.get_many(keys).items()}
            if not any(got == {k: t[k] for k in got} for t in truth):
                errors.append("mixed-generation read")
                stop.set()

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for target in (s2, s1, s2):
            store.swap(target)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        store.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_pin_taken_before_swap_keeps_old_generation(streams):
    _, s1, s2 = streams
    truth = [_truth(s1), _truth(s2)]
    store = _store(s1)
    old_pin = store.pin()
    gen0 = old_pin.generation
    gen1 = store.swap(s2, warm=False)
    assert gen1 != gen0 and store.generation == gen1
    assert {k: _u16(v) for k, v in
            old_pin.get_many(old_pin.keys()).items()} == truth[0]
    with store.pin() as pin:
        assert {k: _u16(v) for k, v in
                pin.get_many(pin.keys()).items()} == truth[1]
    assert store.n_generations == 2
    old_pin.release()
    assert store.n_generations == 1
    with pytest.raises(RuntimeError, match="released"):
        old_pin.get("params/norm")
    store.close()
    with pytest.raises(RuntimeError, match="closed"):
        store.pin()


def test_swap_to_corrupt_stream_leaves_store_serving(streams, tmp_path):
    _, s1, s2 = streams
    bad = str(tmp_path / "half.ceazs")
    with open(s2, "rb") as f:
        data = f.read()
    with open(bad, "wb") as f:
        f.write(data[:len(data) // 2])
    store = _store(s1)
    gen0 = store.generation
    with pytest.raises(E.StreamCorruptionError):
        store.swap(bad)
    assert store.generation == gen0 and store.n_generations == 1
    with store.pin() as pin:
        assert tuple(pin.get("params/norm").shape) == (64,)
    assert store.meta["kind"] == "checkpoint"
    store.close()


def test_duplicate_key_stream_refused_for_paging(tmp_path):
    path = str(tmp_path / "dup.ceazs")
    w = E.StreamWriter(path, fsync=False)
    w.append("params/a", b"first", {"codec": "raw"})
    w.append("params/a", b"again", {"codec": "raw"})
    w.close()
    with pytest.raises(E.StreamCorruptionError, match="duplicate"):
        _store(path, comp=C._compressor(C.CheckpointConfig(), "cpu"))
