#!/usr/bin/env python3
"""chip_smoke.py's serving and training phases alone, with the same
instruments, on one NVIDIA GPU: a quicker run of those paths than the
whole script.

    python3 tools/serve_phase.py [--seed S] [--phases SERVE,SERVE.MOE,SERVE.ZOO,SERVE.SSM,TRAIN,TRAIN.DIST]

It builds the kernels, installs the census and capture hooks as
``chip_smoke.main`` does (``install_recorders``: the phases after SERVE
hold each new kernel key at first sight) and runs the named phases (default: SERVE) in a
temporary directory under ``build/``: ``chip_smoke.run_serve_phase``
(gemma3-1b at its published widths: save, full and paged restore, 4
requests of 600 + 32 tokens, the cut's card-against-CPU checks and the
bf16 limits with their controls), ``run_moe_phase`` (phi3.5-moe's first
layer saved, restored and served; deepseek-v2's dense and first MoE
layers served; both held layer by layer against the CPU) and
``run_zoo_phase`` (five attention archs' full-vocabulary tables saved
and restored, then served a few steps) and ``run_ssm_phase`` (rwkv6-1.6b's
first 4 layers and zamba2-7b's first repeat saved, restored and held
against the CPU; the whole zamba2-7b drawn as bf16 and served) and
``run_train_phase`` (gemma3-1b trained 6 steps at B 2 x S 2048,
checkpointed and resumed from step 3; its card-against-CPU holds) and
``run_dist_phase`` (TRAIN.DIST: gemma3-1b's first repeat trained over 4
gloo processes on the card, the pod exchange, the sharded save and the
restore onto 2, the pipeline and the MoE's expert parallelism; then
SERVE.DIST, serving over the same two worlds' ranks). Then
``serve_kernel_rows`` and
``zoo_kernel_rows`` on the calls the phases kept (each a row of its own
here: no earlier phase made the rows). Prints the card's name and power
limit, chip_smoke's phase lines, the seconds of each phase and of the
kernel holds, and one JSON line of the phases' figures and the held
kernels' times. Exits non-zero if any check fails.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="SERVE",
                    help="comma-separated: SERVE, SERVE.MOE, SERVE.ZOO, "
                         "SERVE.SSM, TRAIN, TRAIN.DIST")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as CS
    from repro_torch.kernels import _build, dispatch
    card = CS.card_line()
    print(f"card: {card}")
    _build.library()
    census, captured = CS.install_recorders(dispatch)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    runs = {"SERVE": CS.run_serve_phase, "SERVE.MOE": CS.run_moe_phase,
            "SERVE.ZOO": CS.run_zoo_phase, "SERVE.SSM": CS.run_ssm_phase,
            "TRAIN": CS.run_train_phase,
            "TRAIN.DIST": lambda dispatch, census, captured, card, d, seed,
            *_: (None, {}, CS.run_dist_phase(dispatch, card, d, seed,
                                             captured=captured)[1])}
    phases = args.phases.split(",")
    inputs, figs, walks, secs = {}, {}, {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        for phase in phases:
            t0 = time.perf_counter()
            extra = () if phase == "SERVE" else (walks,)
            _, inputs[phase], figs[phase] = runs[phase](
                dispatch, census, captured, card, d, args.seed, *extra)
            secs[phase] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = {}
    if "SERVE" in phases:
        CS.serve_kernel_rows({"SERVE": inputs["SERVE"]}, rows)
    CS.zoo_kernel_rows(walks, rows)
    holds_s = time.perf_counter() - t0
    print(f"serve_phase: phases {secs} s, kernel holds {holds_s} s")
    keep = ("ms", "device_ms", "bound_ms", "pct_of_bound", "shape", "cases")
    print(json.dumps({
        "serve": figs,
        "kernels": {n: {k: r.get(k) for k in keep} for n, r in rows.items()},
        "card": card}, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
