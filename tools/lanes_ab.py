#!/usr/bin/env python3
"""The step of chip_smoke.py's phase TRAIN.DIST with each large
all-gather cut over ``runtime/dist.py::LANES`` process groups against
other lane counts, in one run on one NVIDIA GPU (or on the CPU with
``--device cpu --reduced``).

    python3 tools/lanes_ab.py [--order 4,1,1,4] [--seed S]

For each lane count in ``--order`` it starts a world of 4 gloo processes
on the card (``runtime/dist.py::launch``), each setting ``dist.LANES``
before its mesh builds its groups, and runs ``chip_smoke.dist_train``:
(a) (data=2, model=2) in f32 compute and (b) (pod=2, data=1, model=2)
without compression, each DIST_STEPS steps of gemma3-1b's first repeat
at its published widths, global batch DIST_BATCH x DIST_SEQ. Prints the
card's name and power limit, each world's step ms by rank, their
median after the first step and the gloo and staging seconds a step,
and one JSON line of it all (also written to
``chiprun_out/lanes_ab.json``).
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lanes_world(rank, job):
    """One rank of a world of 4 with job["lanes"] process groups a slice:
    (a) and (b) plain -> {case: {"ms", "gloo_s", "staging_s"}}."""
    import torch
    import chip_smoke as CS
    from repro_torch.launch import train as TR
    from repro_torch.optim import CompressionConfig
    from repro_torch.runtime import dist as D
    D.LANES = job["lanes"]
    cfg, dev, seed = CS.dist_config(job["reduced"]), job["dev"], job["seed"]
    cases = (("a", (2, 2), ("data", "model"), TR.TrainConfig(),
              torch.float32),
             ("b.plain", (2, 1, 2), ("pod", "data", "model"),
              TR.TrainConfig(comp=CompressionConfig(bits=CS.DIST_BITS,
                                                    enabled=False)), None))
    out = {}
    for name, shape, axes, tc, dtype in cases:
        plan = TR.make_plan_for(cfg, CS.dist_mesh(shape, axes, dev))
        with CS.compute_dtype(dtype) if dtype is not None else \
                CS.contextlib.nullcontext():
            state, rec = CS.dist_train(rank, plan, cfg, tc, dev, seed)
        del state
        if CS.torch_type(dev) == "cuda":
            torch.cuda.empty_cache()
        out[name] = {k: rec[k] for k in ("ms", "gloo_s", "staging_s")}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--order", default="4,1,1,4",
                    help="lane counts, one world each, in this order")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="gemma3-1b's reduced config (a rehearsal)")
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("lanes_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.runtime import dist as D
    card = CS.card_line() if args.device == "cuda" else "cpu"
    print(f"card: {card}")
    if args.device == "cuda":
        _build.library()
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    runs = []
    for lanes in (int(n) for n in args.order.split(",")):
        job = {"lanes": lanes, "dev": args.device, "seed": args.seed,
               "reduced": args.reduced}
        t0 = time.perf_counter()
        res = [r.result for r in D.launch(lanes_world, 4, args=(job,),
                                          timeout=CS.DIST_TIMEOUT)]
        run = {"lanes": lanes, "world_s": time.perf_counter() - t0}
        for name in res[0]:
            recs = [r[name] for r in res]
            after = lambda key: [x for rec in recs for x in rec[key][1:]]
            run[name] = {
                "step_ms": [rec["ms"] for rec in recs],
                "median_step_ms": statistics.median(after("ms")),
                "median_gloo_s": statistics.median(after("gloo_s")),
                "median_staging_s": statistics.median(after("staging_s"))}
            print(f"lanes {lanes} ({name}) [{card}]: step ms by rank "
                  f"{run[name]['step_ms']}; median after the first "
                  f"{run[name]['median_step_ms']}, gloo "
                  f"{run[name]['median_gloo_s']} s, staging "
                  f"{run[name]['median_staging_s']} s", flush=True)
        runs.append(run)
    line = json.dumps({"lanes_ab": runs, "card": card})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "lanes_ab.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
