"""CEAZ-compressed, fault-tolerant checkpoints (the port of
``src/repro/checkpoint/ckpt.py``).

This is the paper's MPI_File_write scenario made first-class: checkpoint
tensors are compressed with the adaptive CEAZ pipeline (error-bounded,
value-range-relative) before they reach storage. Leaves stream through
the async compression-I/O engine (``repro_torch.io.engine``): the
compression of leaf i+1 on the card overlaps the ordered commit of leaf
i into ONE indexed ``leaves.ceazs`` stream a step.

Fault-tolerance contract:
  * ATOMIC: a checkpoint becomes visible only through os.replace() of a
    completed step directory and of the LATEST pointer file — a crash
    mid-write never corrupts the restore path.
  * VERIFIED: the stream footer carries per-leaf crc32s (and a footer
    checksum); restore refuses corrupted files and falls back to the
    previous step.
  * ELASTIC: tensors are stored in LOGICAL (unsharded) space with the
    tree structure in the manifest, so a restore does not depend on
    where the state was saved from. A state sharded over a rank mesh
    (``launch/mesh.py``) is gathered leaf by leaf to rank 0, which writes
    the one stream; a restore onto a rank mesh of any size places each
    rank's shard of every leaf as it decodes.
  * ASYNC: ``save_checkpoint(..., background=True)`` snapshots to the
    host at call time, then writes off the caller's thread.

Float leaves of at least ``min_compress`` finite values go through CEAZ;
small, integer and bfloat16 leaves are stored raw (bfloat16 and float8
tensors in the stream's ``bytes`` codec). ``mode='raw'`` turns lossy
compression off (bit-exact restore, still atomic and verified). The
stream and the manifest are the reference's for the same tree: a
checkpoint written by either package restores in the other.
"""
from __future__ import annotations

import concurrent.futures as futures
import dataclasses
import hashlib
import io
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..convert import dtype_name, host_leaf, tree_items
from ..core import CEAZ, CEAZConfig
from ..io import engine as E
from ..runtime.sharding import (ShardingPlan, gather_leaf, is_rank_plan,
                                leaf_sharding, param_shardings, plan_device)
from ..runtime.sharding import place as place_leaf

LATEST = "LATEST"
LEAVES_STREAM = "leaves.ceazs"
_EXEC: Optional[futures.ThreadPoolExecutor] = None
_PENDING = []


@dataclasses.dataclass
class CheckpointConfig:
    mode: str = "ceaz"             # 'ceaz' | 'raw'
    eb: float = 5e-4               # value-range-relative bound for params
    predictor: str = "auto"        # weights are noise-like => value-direct
    min_compress: int = 4096       # leaves smaller than this stored raw
    chunk_bytes: int = 1 << 22
    use_fused: bool = True
    # async engine: compress leaf i+1 while committing leaf i; False
    # runs the same stages inline (byte-identical stream)
    overlap: bool = True
    writers: int = 2
    # restore side: leaf records decode in groups of `restore_group` as
    # one batched decode pass each, prefetch of the next group
    # overlapping the decode of the current one
    restore_group: int = 8


def _flatten(tree) -> Dict[str, Any]:
    """{path: host leaf} in ``tree_items`` order (the reference's
    ``keystr`` paths); tensors are copied to the host now."""
    return {key: host_leaf(leaf) for key, leaf in tree_items(tree)}


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of nested
    dicts, lists and tuples, written without jax: ``PyTreeDef({'a': [*,
    *], 't': (*, None)})`` (dict keys sorted, None an empty subtree, any
    other node a leaf)."""
    def node(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(node(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(node(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "None" if t is None else "*"
    return f"PyTreeDef({node(tree)})"


def _compressor(cfg: CheckpointConfig, device="cuda") -> CEAZ:
    return CEAZ(CEAZConfig(mode="rel", eb=cfg.eb,
                           chunk_bytes=cfg.chunk_bytes,
                           predictor=cfg.predictor,
                           use_fused=cfg.use_fused, device=device))


def _leaf_lossy(arr, cfg: CheckpointConfig) -> bool:
    return (cfg.mode == "ceaz" and isinstance(arr, np.ndarray)
            and arr.dtype in (np.float32, np.float64)
            and arr.size >= cfg.min_compress
            and bool(np.all(np.isfinite(arr))))


def _decode_leaf(payload: bytes, meta: Dict, comp: CEAZ):
    """Legacy format-1 (per-leaf files, sha256 meta) decoder."""
    if hashlib.sha256(payload).hexdigest() != meta["sha256"]:
        raise IOError("checkpoint payload hash mismatch (corruption)")
    if meta["codec"] == "ceaz":
        c = E._RecordUnpickler(io.BytesIO(payload)).load()
        out = comp.decompress(c)
        return out.astype(np.dtype(meta["dtype"])).reshape(meta["shape"])
    if meta["codec"] == "bytes":
        return E._from_bytes(payload, meta["dtype"], meta["shape"])
    arr = np.load(io.BytesIO(payload), allow_pickle=False)
    if arr.dtype.kind == "V":        # npy stored an ml_dtypes array as void
        return E._from_bytes(arr.tobytes(), meta["dtype"], arr.shape)
    return arr


def _gathered(state, plan: ShardingPlan, shapes) -> Dict[str, Any]:
    """Rank 0's host snapshot of a state whose leaves are this rank's
    shards of leaves of `shapes` (every rank takes part in each leaf's
    gather; the others get an empty dict)."""
    import torch
    shd = param_shardings(state, plan, shapes=shapes)
    lead = plan.mesh.rank == 0
    flat = {}
    for key, leaf in tree_items(state):
        whole = gather_leaf(torch.as_tensor(leaf), shd[key])
        if lead:
            flat[key] = host_leaf(whole)
        del whole
    return flat


def save_checkpoint(directory: str, state: Any, step: int,
                    extra: Optional[Dict] = None,
                    cfg: Optional[CheckpointConfig] = None,
                    background: bool = False, device="cuda",
                    plan: Optional[ShardingPlan] = None,
                    shapes: Optional[Dict[str, tuple]] = None) -> str:
    """Write state atomically as <directory>/step_<step>/ and update LATEST.

    `state`: a nested dict/list/tuple tree or the port's flat {path:
    leaf} dict of tensors or numpy arrays. Lossy leaves compress on
    `device` (the card unless the caller asks for the CPU). Returns the
    (future) checkpoint path. With background=True the host snapshot
    happens NOW and the file writes on a worker thread
    (:func:`wait_for_pending` joins them, e.g. before process exit).

    With a rank `plan` (a mesh of several processes) `state` holds this
    rank's shards of the leaves whose whole shapes `shapes` gives ({path:
    shape}, ``tree_items`` paths): every rank takes part in gathering
    each leaf to rank 0, which writes the stream; the others wait at a
    barrier until it is written (with `background`, until the snapshot
    is taken)."""
    cfg = cfg or CheckpointConfig()
    ranks = is_rank_plan(plan)
    treedef = treedef_str(state)
    if ranks:
        from ..runtime.dist import barrier
        world = plan.mesh.group(plan.mesh.axis_names)
        flat = _gathered(state, plan, shapes)
        if plan.mesh.rank != 0:
            barrier(world)
            return os.path.join(directory, f"step_{step:08d}")
    else:
        flat = _flatten(state)                  # host snapshot (sync)
    comp = _compressor(cfg, device)

    def _write():
        os.makedirs(directory, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=directory, prefix=f".tmp_step_{step}_")
        manifest = {"step": step, "extra": extra or {},
                    "treedef": treedef, "format": 2,
                    "file": LEAVES_STREAM,
                    "mode": cfg.mode, "leaves": {}}

        def encode(keys, items):
            # lossy float leaves ride the facade; everything else passes
            # through as raw leaves for the npy/bytes codecs
            return [comp.compress(arr.astype(np.float32))
                    if _leaf_lossy(arr, cfg) else arr for arr in items]

        try:
            eng = E.AsyncCompressWriteEngine(
                os.path.join(tmp, LEAVES_STREAM), encode,
                writers=cfg.writers, sync=not cfg.overlap,
                meta={"kind": "checkpoint", "step": step},
                block_size=comp.cfg.block_size)
            with eng:
                for key, arr in sorted(flat.items()):
                    eng.submit(key, arr, meta={
                        "shape": list(arr.shape), "dtype": dtype_name(arr),
                        "raw_nbytes": int(arr.nbytes),
                        **({"eb_rel": cfg.eb}
                           if _leaf_lossy(arr, cfg) else {})})
            for rec in eng.stats.records:
                manifest["leaves"][rec["key"]] = {
                    k: v for k, v in rec.items() if k != "key"}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(directory, f"step_{step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            # atomic LATEST pointer
            ptr_tmp = os.path.join(directory, ".LATEST.tmp")
            with open(ptr_tmp, "w") as f:
                f.write(f"step_{step:08d}")
                f.flush()
                os.fsync(f.fileno())
            os.replace(ptr_tmp, os.path.join(directory, LATEST))
            return final
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    if background:
        global _EXEC
        if _EXEC is None:
            _EXEC = futures.ThreadPoolExecutor(max_workers=1)
        fut = _EXEC.submit(_write)
        _PENDING.append(fut)
        done = os.path.join(directory, f"step_{step:08d}")
    else:
        done = _write()
    if ranks:
        barrier(world)
    return done


def wait_for_pending():
    for f in list(_PENDING):
        f.result()
    _PENDING.clear()


def available_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and os.path.isfile(
                os.path.join(directory, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return sorted(steps)


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       plan: Optional[ShardingPlan] = None,
                       cfg: Optional[CheckpointConfig] = None,
                       template: Any = None,
                       leaf_transform=None, device="cuda"
                       ) -> Optional[Tuple[Any, Dict]]:
    """Restore (state, meta), or None. Falls back to earlier steps on
    corruption.

    Format-2 leaf streams restore through the engine's decode pipeline:
    the prefetch thread reads and deserializes leaf records while groups
    of `cfg.restore_group` leaves decode as one batched pass each on
    `device` (the card unless the caller asks for the CPU). Without a
    mesh in `plan` the leaves are host arrays (numpy; CPU tensors for
    bfloat16 and float8), as in the reference. With one, every leaf is
    placed by its PARAM_RULES :func:`leaf_sharding` as soon as it
    decodes: on a rank mesh each rank keeps its own shard of every leaf
    (every rank reads and decodes the stream), so a state saved from a
    mesh of any size restores onto a mesh of any other.

    `leaf_transform(key, arr) -> arr` runs on each decoded host leaf
    BEFORE placement, so a serving-dtype cast happens while only that
    one leaf exists in both precisions."""
    cfg = cfg or CheckpointConfig()
    steps = available_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    if not steps:
        return None
    comp = _compressor(cfg, device)
    sharded = plan_device(plan, "restore_checkpoint") is not None

    def place(key: str, arr):
        """Per-leaf transform, then placement on the restore mesh."""
        if leaf_transform is not None:
            arr = leaf_transform(key, arr)
        if not sharded:
            return arr
        return place_leaf(arr, leaf_sharding(key, tuple(arr.shape), plan))

    for s in reversed(steps):
        d = os.path.join(directory, f"step_{s:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            flat = {}
            if manifest.get("format", 1) >= 2:
                stream = os.path.join(d, manifest.get("file",
                                                      LEAVES_STREAM))
                with E.AsyncDecodeReadEngine(
                        stream, comp, group=cfg.restore_group) as eng:
                    for rec, obj in eng:
                        if rec.get("codec") == "ceaz":
                            obj = obj.astype(np.dtype(rec["dtype"])) \
                                .reshape(rec["shape"])
                        flat[rec["key"]] = place(rec["key"], obj)
            else:                                  # legacy per-leaf files
                for key, meta in manifest["leaves"].items():
                    with open(os.path.join(d, meta["file"]), "rb") as f:
                        flat[key] = place(key, _decode_leaf(f.read(),
                                                            meta, comp))
            state = _unflatten_like(flat, template)
            return state, {"step": manifest["step"],
                           **manifest.get("extra", {})}
        except Exception as e:                      # corrupted -> try older
            print(f"checkpoint {d} unusable ({e}); trying previous")
            continue
    return None


def _unflatten_like(flat: Dict[str, Any], template: Any):
    """Rebuild the nested dict/list structure from 'a/b/0/c' paths."""
    root: Dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def fix(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.lstrip("-").isdigit() for k in keys):
                return [fix(node[k]) for k in sorted(keys, key=int)]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)
