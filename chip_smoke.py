#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, then
drives the port's main path — ``CEAZ.compress`` -> ``CEAZ.decompress``
on the fused abs/rel Lorenzo route — through the public facade:

  phase A  CESM-like 2-D field, 1800x3600 f32 (25.9 MB, the size of the
           paper's CESM-ATM fields), rel eb 1e-4, default 32 MB chunks
           (one chunk): dq2d, gather-pack, word-tiled walk kernels;
  phase B  HACC-like 1-D field, 2^23 f32 (32 MB), rel eb 1e-4,
           chunk_bytes=2^19 (64 chunks of 2^17 values): dq1d,
           gather-pack, decode-megakernel kernels, the Lorenzo chain
           carried across all 64 rows.

Each phase is run with the kernels' launch counts set to 0 just before
and read just after, and must launch every kernel of its path. Its
stream (every CompressedChunk field, the literals) and decoded bytes
must equal the port's own CPU run of the same input bit for bit, and
the reconstruction must hold the error bound. Every kernel is then
called on the inputs the main path gave it and held BITWISE against its
plain PyTorch version on the card (integer outputs: tolerance 0), and
timed (CUDA events, median after warm-up). The script prints the card
(nvidia-smi name and power limit), the build time, per-kernel results,
compress/decompress throughput, one JSON line of kernels and, last,
``{"ok": true, "device": {...}}``. Any failed check raises: the exit
code is then non-zero and the last line is not printed.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
REPLACES = {
    "dq1d": "src/repro/kernels/dualquant/kernel.py:101",
    "dq2d": "src/repro/kernels/dualquant/kernel.py:131",
    "gather_pack_tiled": "src/repro/kernels/hufenc/kernel.py:267",
    "hufdec_tiles": "src/repro/kernels/megakernel/decode_kernel.py:246",
    "ceaz_chunk_dec_fused":
        "src/repro/kernels/megakernel/decode_kernel.py:146",
}
SOURCES = {
    "dq1d": "src/repro_torch/csrc/dualquant.cu",
    "dq2d": "src/repro_torch/csrc/dualquant.cu",
    "gather_pack_tiled": "src/repro_torch/csrc/hufenc.cu",
    "hufdec_tiles": "src/repro_torch/csrc/hufdec.cu",
    "ceaz_chunk_dec_fused": "src/repro_torch/csrc/decode_fused.cu",
}
PHASE_KERNELS = {"A": ("dq2d", "gather_pack_tiled", "hufdec_tiles"),
                 "B": ("dq1d", "gather_pack_tiled", "ceaz_chunk_dec_fused")}


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5, warmup=2):
    """Median wall time on the card of fn(), by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_s(fn, reps=3):
    """Median host seconds of fn() ending in a device sync."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def same_outputs(a, b):
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and bool((x == y).all())
        for x, y in zip(a, b))


def assert_same_stream(g, c, phase):
    """Every CEAZCompressed field of the card's run equals the CPU run's."""
    import numpy as np
    for k in ("shape", "dtype", "ndim", "mode", "word_bits", "predictor"):
        check(getattr(g, k) == getattr(c, k), f"{phase}: {k} differs")
    check(len(g.chunks) == len(c.chunks), f"{phase}: chunk count differs")
    for i, (a, b) in enumerate(zip(g.chunks, c.chunks)):
        for k in ("n_values", "eb", "action", "chi", "codebook_id",
                  "center", "bank_ref", "bank_index"):
            check(getattr(a, k) == getattr(b, k),
                  f"{phase}: chunk {i} {k} differs")
        for k in ("words", "block_nbits", "outlier_idx", "outlier_delta"):
            x, y = getattr(a, k), getattr(b, k)
            check(x.dtype == y.dtype and np.array_equal(x, y),
                  f"{phase}: chunk {i} {k} differs")
        la, lb = a.codebook_lengths, b.codebook_lengths
        check((la is None) == (lb is None)
              and (la is None or np.array_equal(la, lb)),
              f"{phase}: chunk {i} codebook_lengths differ")
    check(np.array_equal(g.literal_idx, c.literal_idx),
          f"{phase}: literal_idx differs")
    check(g.literal_val.tobytes() == c.literal_val.tobytes(),
          f"{phase}: literal_val differs")


def span_breakdown(fn, dispatch):
    """Total ms per span name over one traced call of fn, with the kernel
    passes synced so each `kernel.<op>` span holds its device time."""
    import torch
    from repro_torch.obs import trace as ot
    tracer = ot.enable()
    tracer.clear()
    dispatch.set_timing(True)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        dispatch.set_timing(False)
        ot.disable()
    totals = {}
    for ev in tracer.events():
        totals[ev["name"]] = totals.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return {k: round(v, 3) for k, v in sorted(totals.items())}


def run_phase(name, x, kw, offline, dispatch, CEAZ, CEAZConfig, captured):
    """Counted main-path run on the card + the CPU run it must equal."""
    import numpy as np
    from repro_torch.core.dualquant import value_range
    gpu = CEAZ(CEAZConfig(device="cuda", **kw), offline_codebook=offline)
    cpu = CEAZ(CEAZConfig(device="cpu", **kw), offline_codebook=offline)
    captured.clear()
    dispatch.reset_launches()
    c_gpu = gpu.compress(x)
    y_gpu = gpu.decompress(c_gpu)
    import torch
    torch.cuda.synchronize()
    counts = dispatch.launches()
    for k in PHASE_KERNELS[name]:
        check(counts.get(k, 0) > 0,
              f"phase {name}: kernel {k} was not launched ({counts})")
    inputs = dict(captured)
    t0 = time.perf_counter()
    c_cpu = cpu.compress(x)
    y_cpu = cpu.decompress(c_cpu)
    cpu_s = time.perf_counter() - t0
    assert_same_stream(c_gpu, c_cpu, f"phase {name}")
    check(y_gpu.tobytes() == y_cpu.tobytes(),
          f"phase {name}: decoded bytes differ from the CPU run")
    bound = kw["eb"] * value_range(x)
    err = float(np.abs(y_gpu.astype(np.float64)
                       - x.astype(np.float64)).max())
    check(err <= bound, f"phase {name}: max error {err} > bound {bound}")
    enc_s = host_s(lambda: gpu.compress(x))
    dec_s = host_s(lambda: gpu.decompress(c_gpu))
    gb = x.nbytes / 1e9
    print(f"phase {name} spans (ms, one traced round trip, kernel passes "
          f"synced): {span_breakdown(lambda: gpu.decompress(gpu.compress(x)), dispatch)}")
    print(f"phase {name}: shape={x.shape} chunks={len(c_gpu.chunks)} "
          f"ratio={c_gpu.ratio()} max_err={err} bound={bound} "
          f"literals={len(c_gpu.literal_idx)} launches={counts} "
          f"stream+bytes==cpu run: True (cpu run {cpu_s:.2f} s)")
    return counts, inputs, dict(compress_GBps=gb / enc_s,
                                decompress_GBps=gb / dec_s,
                                compress_s=enc_s, decompress_s=dec_s)


def kernel_rows(inputs_a, inputs_b):
    """Each kernel on its main-path inputs: bitwise vs plain, timed."""
    import torch
    from repro_torch.kernels.dualquant import ops as DQ
    from repro_torch.kernels.hufdec import ops as HD
    from repro_torch.kernels.hufenc import ops as HE
    from repro_torch.kernels.megakernel import ops as MK
    rows = {}

    def row(name, cuda_fn, plain_fn, in_bytes, out_bytes, ops, extra=None):
        got = cuda_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        check(same_outputs(got, want),
              f"kernel {name} disagrees with its plain version")
        ms = cuda_ms(cuda_fn)
        plain_ms = cuda_ms(plain_fn, reps=3, warmup=1)
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        rows[name] = dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=0, max_abs_err=0,
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, **(extra or {}))
        print(f"kernel {name}: bitwise == plain: True  ms={ms} "
              f"plain_ms={plain_ms} bound_ms={rows[name]['bound_ms']} "
              f"({rows[name]['bound_by']}; {in_bytes + out_bytes} B, "
              f"{ops} ops)")

    for name, inp in (("dq2d", inputs_a), ("dq1d", inputs_b)):
        work, eb, ndim, n_out = inp["dualquant"][0]
        n = work.numel()
        row(name, lambda: DQ.dual_quantize_cuda(work, eb, ndim, n_out),
            lambda: DQ.dual_quantize_plain(work, eb, ndim, n_out),
            in_bytes=4 * n, out_bytes=9 * n_out + 4 * n,
            ops=(4 if ndim == 2 else 2) * 12 * n)

    for phase, inp in (("B", inputs_b), ("A", inputs_a)):
        args = inp["hufenc"][0]
        codes2, valid2, ln, cw, bs, w32 = args
        C, cv = codes2.shape
        nblocks = -(-cv // bs)
        row("gather_pack_tiled", lambda: HE.encode_pack_cuda(*args),
            lambda: HE.encode_pack_plain(*args),
            in_bytes=nbytes(codes2, valid2, ln, cw),
            out_bytes=4 * C * (w32 + nblocks),
            ops=int(valid2.sum()) * 8,
            extra=dict(phase=phase))

    for name, dec, wrapper, plain, ops_per_symbol in (
            ("hufdec_tiles", inputs_a["ceaz_chunk_dec"][0],
             lambda d: HD.hufdec_tiles_cuda(*d[:6], d[10]),
             lambda d: HD.hufdec_tiles_plain(*d[:6], d[10]), 12),
            ("ceaz_chunk_dec_fused", inputs_b["ceaz_chunk_dec"][0],
             lambda d: MK.ceaz_chunk_dec_fused_cuda(*d),
             lambda d: MK.ceaz_chunk_dec_plain(*d), 20)):
        words2, nbits2, counts = dec[:3]
        bs = dec[10]
        C, NB = nbits2.shape
        # the walk's inputs (the fused kernel also reads the patch/inverse
        # metadata); its output is every (chunk, block) lane's q row
        n_in = 6 if name == "hufdec_tiles" else 10
        q_like = torch.zeros((C, NB * bs), dtype=torch.int32,
                             device=words2.device)
        row(name, lambda: wrapper(dec), lambda: plain(dec),
            in_bytes=nbytes(*dec[:n_in]), out_bytes=4 * C * NB * bs,
            ops=ops_per_symbol * int(counts.sum()),
            extra=dict(cumsum_ms=cuda_ms(lambda: torch.cumsum(q_like, 1))))
    return rows


def nonfinite_check():
    """dq1d/dq2d on NaN/+-Inf/+-3e9: PTX's float->int cast is not relied
    on, but the kernels' outputs must equal the plain version's."""
    import numpy as np
    import torch
    from repro_torch.kernels.dualquant import ops as DQ
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.standard_normal(3 * 4096)).astype(np.float32)
    x[::7] = np.nan
    x[1::11] = np.inf
    x[2::13] = -np.inf
    x[3::17] = 3e9
    x[4::19] = -3e9
    for shape in ((x.size,), (3, 4096)):
        w = torch.from_numpy(x.reshape(shape)).cuda()
        got = DQ.dual_quantize_cuda(w, 1e-3, len(shape), x.size + 5)
        want = DQ.dual_quantize_plain(w.cpu(), 1e-3, len(shape), x.size + 5)
        check(same_outputs([t.cpu() for t in got], list(want)),
              f"dq{len(shape)}d disagrees with plain on non-finite inputs")
    print("dq1d/dq2d on NaN/+-Inf/+-3e9 inputs == plain (cpu): True")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import CEAZ, CEAZConfig, default_offline_codebook
    from repro_torch.data import fields as F
    from repro_torch.kernels import _build, dispatch

    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'ran' if _build.build_seconds else 'reused a build'})")
    for line in _build.ptxas_log().splitlines():
        if "registers" in line or line.startswith("=="):
            print("  ptxas:", line.strip())

    captured = {}
    for op in ("dualquant", "hufenc", "ceaz_chunk_dec"):
        fn = dispatch.resolve(op, "cuda", "cuda")

        def recorder(*a, _fn=fn, _op=op):
            captured.setdefault(_op, (a,))
            return _fn(*a)
        dispatch.register(op, "cuda", lambda _r=recorder: _r)

    offline = default_offline_codebook()
    x_a = F.cesm_proxy(size="medium")
    x_b = F.hacc_proxy(size="medium")
    check(x_a.shape == (1800, 3600) and x_b.shape == (1 << 23,),
          "unexpected phase shapes")
    counts_a, in_a, thr_a = run_phase(
        "A", x_a, dict(mode="rel", eb=1e-4), offline, dispatch, CEAZ,
        CEAZConfig, captured)
    counts_b, in_b, thr_b = run_phase(
        "B", x_b, dict(mode="rel", eb=1e-4, chunk_bytes=1 << 19), offline,
        dispatch, CEAZ, CEAZConfig, captured)
    for op in ("dualquant", "hufenc", "ceaz_chunk_dec"):
        check(op in in_a and op in in_b, f"{op} inputs were not captured")

    rows = kernel_rows(in_a, in_b)
    nonfinite_check()
    for name, r in rows.items():
        r["launches"] = counts_a.get(name, 0) + counts_b.get(name, 0)
    for name, thr in (("A", thr_a), ("B", thr_b)):
        print(f"throughput phase {name} [{card}]: "
              f"compress {thr['compress_GBps']} GB/s "
              f"({thr['compress_s']} s), decompress "
              f"{thr['decompress_GBps']} GB/s ({thr['decompress_s']} s) "
              f"of f32 input")
    print(json.dumps({"throughput": {"A": thr_a, "B": thr_b},
                      "card": card}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
