"""The port's compressed checkpoints (``repro_torch/checkpoint/ckpt.py``)
against the reference's, on the CPU.

The reference's own cases (``tests/test_checkpoint.py``: the bound, raw
mode bit-exact, corruption fallback, an interrupted write invisible, an
async save) run on a numpy tree of 2-D and 3-D f32 leaves, a bfloat16
leaf, an int leaf and leaves under ``min_compress``; then the manifest
against the reference's for the same tree, each package restoring the
other's checkpoint, a hand-made format-1 directory, and
``leaf_transform`` before placement on a one-device mesh.
"""
import hashlib
import io
import json
import os
import pickle

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RC
from repro.core import CEAZ as RCEAZ
from repro.core import CEAZConfig as RConfig
from repro_torch.checkpoint import ckpt as C
from repro_torch.launch import mesh as LM
from repro_torch.runtime import sharding as S

STEP_DIR = "step_{:08d}"


def _tree(seed=0, bf16=True):
    """{'params': {...}, 'opt': {...}}: lossy 2-D/3-D f32 leaves, a small
    f32 norm, an int step and (optionally) a bfloat16 leaf as numpy
    arrays of ml_dtypes (the reference's form of it)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = {"params": {"embed": {"table": mk(128, 64)},
                    "layers": [{"mlp": {"wi": mk(64, 96),
                                        "wo": mk(16, 24, 16)}},
                               {"mlp": {"wi": mk(64, 96) * 3 + 1,
                                        "wo": mk(16, 24, 16)}}],
                    "norm": np.ones(64, np.float32)},
         "opt": {"count": np.int32(7), "lr": np.asarray(3e-4, np.float32),
                 "small": mk(100)},
         "pair": (mk(33, 7), None)}
    if bf16:
        t["params"]["emb16"] = mk(32, 16).astype(ml_dtypes.bfloat16)
    return t


def _port_tree(tree):
    """The same tree with its bfloat16 leaf as a torch.bfloat16 tensor
    (how ``convert.tree_from_reference`` carries it)."""
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_port_tree(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()) \
            .view(torch.bfloat16)
    return tree


def _bits(a):
    """A leaf's raw bytes and dtype name (bfloat16 as its 16 bits)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy().view(ml_dtypes.bfloat16) \
            if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return str(a.dtype), a.shape, a.tobytes()


def _leaves(tree):
    return [v for _, v in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]]


def _save(d, tree, step, **kw):
    return C.save_checkpoint(str(d), _port_tree(tree), step, device="cpu",
                             **kw)


def _restore(d, **kw):
    return C.restore_checkpoint(str(d), device="cpu", **kw)


def test_save_restore_within_bound(tmp_path):
    tree = _tree()
    _save(tmp_path, tree, 5)
    restored, meta = _restore(tmp_path)
    assert meta["step"] == 5
    for a, b in zip(_leaves(tree), _leaves(restored)):
        if isinstance(b, torch.Tensor) or a.dtype != np.float32 \
                or a.size < C.CheckpointConfig.min_compress:
            assert _bits(a) == _bits(b)           # stored raw
            continue
        assert b.dtype == a.dtype and b.shape == a.shape
        vr = max(float(a.max() - a.min()), 1e-9)
        assert np.abs(a - b).max() <= 5e-4 * vr * (1 + 1e-6)


def test_raw_mode_bit_exact(tmp_path):
    tree = _tree()
    cfg = C.CheckpointConfig(mode="raw")
    _save(tmp_path, tree, 1, cfg=cfg)
    restored, _ = _restore(tmp_path, cfg=cfg)
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert _bits(a) == _bits(b)


def test_corruption_falls_back(tmp_path, capsys):
    _save(tmp_path, _tree(0), 1)
    _save(tmp_path, _tree(1), 2)
    stream = os.path.join(tmp_path, STEP_DIR.format(2), C.LEAVES_STREAM)
    with open(stream, "r+b") as f:
        f.seek(os.path.getsize(stream) // 2)
        f.write(b"corrupted")                  # flips payload bytes mid-leaf
    restored, meta = _restore(tmp_path)
    assert meta["step"] == 1
    assert "unusable" in capsys.readouterr().out
    assert _bits(restored["opt"]["small"]) == _bits(_tree(0)["opt"]["small"])
    assert _restore(tmp_path, step=2) is None


def test_interrupted_write_invisible(tmp_path):
    _save(tmp_path, _tree(), 1)
    os.makedirs(os.path.join(tmp_path, ".tmp_step_9_partial"))
    assert C.available_steps(str(tmp_path)) == [1]
    assert C.available_steps(str(tmp_path / "missing")) == []
    with open(os.path.join(tmp_path, C.LATEST)) as f:
        assert f.read() == STEP_DIR.format(1)


def test_async_save_snapshots_at_call_time(tmp_path):
    leaf = torch.arange(5000, dtype=torch.float32)
    path = C.save_checkpoint(str(tmp_path), {"w": leaf, "n": torch.ones(3)},
                             7, background=True, device="cpu")
    leaf.zero_()                       # after the call: not in the save
    C.wait_for_pending()
    assert path == os.path.join(tmp_path, STEP_DIR.format(7))
    restored, meta = _restore(tmp_path)
    assert meta["step"] == 7
    vr = 4999.0
    assert np.abs(restored["w"] - np.arange(5000)).max() <= 5e-4 * vr
    assert restored["n"].tobytes() == np.ones(3, np.float32).tobytes()


def _manifest(d, step):
    with open(os.path.join(d, STEP_DIR.format(step), "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32-int", "with-bf16"])
def test_manifest_matches_reference(tmp_path, bf16):
    tree = _tree(bf16=bf16)
    _save(tmp_path / "port", tree, 3, extra={"loss": 1.5})
    RC.save_checkpoint(str(tmp_path / "ref"), tree, 3, extra={"loss": 1.5})
    mp, mr = _manifest(tmp_path / "port", 3), _manifest(tmp_path / "ref", 3)
    assert mp["treedef"] == mr["treedef"] \
        == str(jax.tree_util.tree_structure(tree))
    assert C.treedef_str(_port_tree(tree)) == mr["treedef"]
    if bf16:
        # ROADMAP Queue 3: the reference writes an ml_dtypes leaf as npy
        # with a void descr, the port as the spec's `bytes` codec
        key = "params/emb16"
        assert (mp["leaves"][key]["codec"], mr["leaves"][key]["codec"]) \
            == ("bytes", "npy")
        # ... so every later record sits at another offset
        for m in (mp, mr):
            m["leaves"].pop(key)
            for rec in m["leaves"].values():
                rec.pop("offset")
    assert mp == mr


def test_each_package_restores_the_others(tmp_path):
    tree = _tree(2)
    _save(tmp_path / "port", tree, 4)
    RC.save_checkpoint(str(tmp_path / "ref"), tree, 4)
    mine, m1 = _restore(tmp_path / "ref")
    theirs, m2 = RC.restore_checkpoint(str(tmp_path / "port"))
    own, _ = _restore(tmp_path / "port")
    assert m1 == m2 == {"step": 4}
    a, b, c = _leaves(mine), _leaves(theirs), _leaves(own)
    assert len(a) == len(b) == len(c) == len(_leaves(tree))
    for x, y, z in zip(a, b, c):
        assert _bits(x) == _bits(y) == _bits(z)


def test_format1_directory_restores(tmp_path):
    """A legacy per-leaf directory (sha256 meta) written by hand: a ceaz
    record pickled by the reference, an npy leaf and a bytes leaf."""
    rng = np.random.default_rng(9)
    w = np.cumsum(rng.standard_normal(6000)).astype(np.float32)
    ints = np.arange(6, dtype=np.int64).reshape(2, 3)
    half = rng.standard_normal(8).astype(ml_dtypes.bfloat16)
    rc = RCEAZ(RConfig(mode="rel", eb=5e-4, predictor="auto",
                       use_fused=True)).compress(w)
    bio = io.BytesIO()
    np.save(bio, ints, allow_pickle=False)
    payloads = {"w": (pickle.dumps(rc), "ceaz", w),
                "ints": (bio.getvalue(), "npy", ints),
                "half": (half.tobytes(), "bytes", half)}
    d = tmp_path / STEP_DIR.format(1)
    os.makedirs(d)
    leaves = {}
    for i, (key, (pay, codec, arr)) in enumerate(payloads.items()):
        (d / f"leaf_{i}.bin").write_bytes(pay)
        leaves[key] = {"file": f"leaf_{i}.bin", "codec": codec,
                       "sha256": hashlib.sha256(pay).hexdigest(),
                       "dtype": str(arr.dtype), "shape": list(arr.shape)}
    (d / "manifest.json").write_text(json.dumps(
        {"step": 1, "extra": {"e": 2}, "leaves": leaves}))
    mine, meta = _restore(tmp_path)
    theirs, rmeta = RC.restore_checkpoint(str(tmp_path))
    assert meta == rmeta == {"step": 1, "e": 2}
    for k in payloads:
        assert _bits(mine[k]) == _bits(theirs[k]), k
    assert _bits(mine["ints"]) == _bits(ints)
    assert _bits(mine["half"]) == _bits(half)
    # a payload that no longer matches its hash is refused
    (d / "leaf_1.bin").write_bytes(b"tampered")
    assert _restore(tmp_path) is None


def test_leaf_transform_runs_before_placement(tmp_path):
    tree = _tree(3, bf16=False)
    _save(tmp_path, tree, 2)
    plan = S.make_plan(LM.make_mesh((1, 1), ("data", "model"),
                                    devices=["cpu"]))
    seen = []

    def cast(key, arr):
        seen.append((key, type(arr)))
        t = torch.from_numpy(np.asarray(arr))
        return t.to(torch.bfloat16) if t.is_floating_point() else t
    restored, _ = _restore(tmp_path, plan=plan, leaf_transform=cast)
    full, _ = _restore(tmp_path)
    keys = [k for k, _ in seen]
    assert keys == sorted(keys) and len(keys) == len(_leaves(tree))
    assert all(t is np.ndarray for _, t in seen)    # host leaves, pre-cast
    for a, b in zip(_leaves(full), _leaves(restored)):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        ref = torch.from_numpy(np.asarray(a))
        if ref.is_floating_point():
            ref = ref.to(torch.bfloat16)
        assert b.dtype == ref.dtype and torch.equal(b, ref)
    two = S.make_plan(LM.make_mesh((2, 1), ("data", "model"),
                                   devices=["cuda:0", "cuda:1"]))
    with pytest.raises(ValueError, match="one process a position"):
        _restore(tmp_path, plan=two)
