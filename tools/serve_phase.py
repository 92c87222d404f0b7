#!/usr/bin/env python3
"""chip_smoke.py's phase SERVE alone, with the same instruments, on one
NVIDIA GPU: a quicker run of the serving path than the whole script.

    python3 tools/serve_phase.py [--seed S]

It builds the kernels, wraps the census and capture hooks as
``chip_smoke.main`` does, runs ``chip_smoke.run_serve_phase`` (gemma3-1b
at its published widths: save, full and paged restore, 4 requests of
600 + 32 tokens, the cut's card-against-CPU checks and the bf16 limits
with their controls) in a temporary directory under ``build/``, then
``chip_smoke.serve_kernel_rows`` on the calls the phase kept (each a
row of its own here: no earlier phase made the rows). Prints the card's
name and power limit, chip_smoke's phase lines, the seconds of the phase
and of the kernel holds, and one JSON line of the phase's figures and
the held kernels' times. Exits non-zero if any check fails.
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
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as CS
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.dualquant import ops as DQ
    from repro_torch.kernels.hufenc import ops as HE
    from repro_torch.kernels.megakernel import ops as MK
    card = CS.card_line()
    print(f"card: {card}")
    _build.library()
    census = CS.Censuses()
    HE.encode_pack_cuda = census.pack.wrap(HE.encode_pack_cuda)
    MK.ceaz_chunk_cuda = census.op.wrap(MK.ceaz_chunk_cuda)
    DQ.dq_center_cuda = census.center.wrap(DQ.dq_center_cuda)
    HE.hufenc_cuda = census.flat.wrap(HE.hufenc_cuda)
    captured = {}
    for op in CS.CAPTURED_OPS:
        if not dispatch.available(op):
            continue
        fn = dispatch.resolve(op, "cuda", "cuda")

        def recorder(*a, _fn=fn, _op=op):
            captured.setdefault(_op, (a,))
            keep = CS.KEEP_CALLS.get(_op)
            if keep is not None and keep(a):
                captured.setdefault(_op + ".kept", []).append(a)
            return _fn(*a)
        dispatch.register(op, "cuda", lambda _r=recorder: _r)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        _, inputs, figs = CS.run_serve_phase(dispatch, census, captured,
                                             card, d, args.seed)
    phase_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = {}
    CS.serve_kernel_rows({"SERVE": inputs}, rows)
    holds_s = time.perf_counter() - t0
    print(f"serve_phase: phase {phase_s} s, kernel holds {holds_s} s")
    keep = ("ms", "device_ms", "bound_ms", "pct_of_bound", "shape", "cases")
    print(json.dumps({
        "serve": {k: v for k, v in figs.items()
                  if isinstance(v, (int, float, dict))},
        "kernels": {n: {k: r.get(k) for k in keep} for n, r in rows.items()},
        "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
