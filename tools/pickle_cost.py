#!/usr/bin/env python3
"""What pickling the port's ``ceaz`` records costs in the stream engine's
write, on one NVIDIA GPU.

    python3 tools/pickle_cost.py [--seed S] [--reps N]

chip_smoke.py's phase W writes 4 Nyx-like 256^3 f32 ranks through
``io.filewrite.parallel_compressed_write`` (the default facade on the
card, rel 1e-4, fused, 4 serialize workers, groups of 2). This script
compresses the same ranks with the same facade and, with the card and
the engine idle, times each record's pickling (median of ``--reps``):

  record_pickler  ``io.engine.serialize_payload``: the pure-Python
                  ``_RecordPickler``, which writes the reference's class
                  path;
  c_pickler       ``pickle.dumps(obj, protocol=4)``: the C pickler, under
                  the port's own class names (other bytes, same fields).

Then it runs the engine's write of the same ranks (``write_stream``, fsync
on, warm) as W runs it (overlapped, 4 workers), overlapped with one
worker, and synchronously (each record pickled in the caller's thread
with nothing beside it), ``--reps`` times each in turns, and reports each
run's ``serialize_s`` (the sum of the records' pickling seconds, each
timed by the worker that pickled it), ``compress_s``, ``write_s``,
``wall_s`` and ``overlap_efficiency``. Prints one JSON line and the
card's name and power limit.
"""
import argparse
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 4


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip()


def median_s(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="chip_smoke.py's --seed (the ranks' data)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import CEAZ, CEAZConfig
    from repro_torch.data import fields as F
    from repro_torch.io import engine as E

    card = card_line()
    ranks = [F.nyx_proxy(seed=5 + N_RANKS * args.seed + r, size="medium")
             for r in range(N_RANKS)]
    comp = CEAZ(CEAZConfig(mode="rel", eb=1e-4, use_fused=True,
                           device="cuda"))
    objs = [comp.compress(x) for x in ranks]
    torch.cuda.synchronize()
    records = []
    for obj in objs:
        ours = E.serialize_payload(obj)[0]
        c_bytes = pickle.dumps(obj, protocol=4)
        records.append(dict(
            n_chunks=len(obj.chunks), payload_bytes=len(ours),
            c_pickler_bytes=len(c_bytes),
            record_pickler_s=median_s(lambda o=obj: E.serialize_payload(o),
                                      args.reps),
            c_pickler_s=median_s(lambda o=obj: pickle.dumps(o, protocol=4),
                                 args.reps)))

    runs = {"overlap_4_workers": dict(sync=False, writers=4),
            "overlap_1_worker": dict(sync=False, writers=1),
            "sync": dict(sync=True, writers=4)}
    engine = {name: [] for name in runs}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "w.ceazs")
        E.write_stream(path, ranks, comp, group=2, writers=4)   # warm-up
        for _ in range(args.reps):
            for name, kw in runs.items():
                st = E.write_stream(path, ranks, comp, group=2, fsync=True,
                                    **kw).as_dict()
                engine[name].append({k: st[k] for k in (
                    "wall_s", "compress_s", "serialize_s", "write_s",
                    "overlap_efficiency")})
    summary = {name: {k: statistics.median(r[k] for r in rows)
                      for k in rows[0]}
               for name, rows in engine.items()}
    print(json.dumps({"records": records, "engine_median": summary,
                      "engine_runs": engine, "reps": args.reps,
                      "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
