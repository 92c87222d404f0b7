"""Parallel compressed file write: the paper's MPI_File_write scenario
(PyTorch port of the reference's ``io/filewrite.py``).

Each rank compresses its shard with the full adaptive CEAZ pipeline and
the payloads land in ONE aggregated, self-describing stream file — the
two-phase collective-write shape: phase 1 (per-rank compression, the
facade's passes on the card) overlaps phase 2 (ordered aggregated
append) through :mod:`repro_torch.io.engine`. The stream is written to
a temp name and renamed only when the footer is committed.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from ..core import CEAZ, CEAZConfig
from . import engine as E

DUMP_NAME = "dump.ceazs"


def parallel_compressed_write(directory: str, shards: Sequence[np.ndarray],
                              comp: Optional[CEAZ] = None,
                              workers: int = 4, use_fused: bool = True,
                              plan=None, overlap: bool = True,
                              group: int = 2,
                              emulate_bps: Optional[float] = None,
                              fsync: bool = True,
                              device: str = "cuda") -> dict:
    """Compress + write shards into <directory>/dump.ceazs; returns stats.

    With ``overlap`` (default) the async engine double-buffers: the
    facade compresses shard group i+1 on the card while the committer
    appends group i. ``overlap=False`` is the synchronous run —
    byte-identical output, serial timing. The compression policy lives
    entirely in the facade: float64, ragged or value-direct shards take
    whichever route ``CEAZ.compress_batch`` gives them. ``use_fused=False``
    rebuilds the facade on the staged route with the same offline
    codebook. With `comp` omitted the facade is the default one on
    `device` (rel eb 1e-4, fused), which raises without a card for
    ``'cuda'``.
    """
    comp = comp or CEAZ(CEAZConfig(mode="rel", eb=1e-4, use_fused=True,
                                   device=device))
    if not use_fused:
        comp = CEAZ(dataclasses.replace(comp.cfg, use_fused=False),
                    offline_codebook=comp.offline)
    os.makedirs(directory, exist_ok=True)
    shards = [np.asarray(s) for s in shards]
    stats = E.write_stream(
        os.path.join(directory, DUMP_NAME), shards, comp,
        sync=not overlap, group=group, writers=workers,
        meta={"kind": "parallel_dump", "n_shards": len(shards),
              "dtype": str(shards[0].dtype) if shards else None,
              "shapes": [list(s.shape) for s in shards]},
        plan=plan, emulate_bps=emulate_bps, fsync=fsync)
    d = stats.as_dict()
    per_shard = [dict(rank=i, raw=int(r.get("raw_nbytes", 0)),
                      stored=int(r["nbytes"]))
                 for i, r in enumerate(d.pop("records"))]
    raw = max(d["raw_bytes"], 1)
    return dict(wall_s=d["wall_s"], raw_bytes=d["raw_bytes"],
                stored_bytes=d["stored_bytes"],
                ratio=d["raw_bytes"] / max(d["stored_bytes"], 1),
                effective_mbs=raw / max(d["wall_s"], 1e-9) / 1e6,
                compress_s=d["compress_s"], serialize_s=d["serialize_s"],
                write_s=d["write_s"],
                overlap_efficiency=d["overlap_efficiency"],
                shards=per_shard)


def parallel_read(directory: str, comp: Optional[CEAZ] = None,
                  device: str = "cuda") -> List[np.ndarray]:
    """Validate + decompress every shard of a dump stream (index, record
    headers and checksums verified; corruption raises loudly). With
    `comp` omitted the reader self-configures a facade on `device` from
    the stream's footer meta (decode block grain, codebook bank) and
    takes the fused decode path."""
    return E.read_stream_arrays(os.path.join(directory, DUMP_NAME), comp,
                                device=device)
