#!/usr/bin/env python3
"""Designs of the staged route's large-chunk packer (csrc/hufenc.cu::
hufenc_kernel) timed against each other on one NVIDIA GPU.

    python3 tools/hufenc_designs.py [--designs a,b,...] [--reps N]

Each design is a copy of ``src/repro_torch`` under
``build/hufenc_designs/<design>/src`` whose ``csrc/hufenc.cu`` is the
committed one rewritten:

  final           the committed kernel: runs loaded into registers, the
                  next tile prefetched into the L2 by a TMA bulk
                  prefetch, status words published without a fence;
  no_prefetch     without the L2 prefetch;
  fenced          with a __threadfence before each status word;
  fenced_no_prefetch  both (the kernel's first register design);
  tma_ring        each tile's codes copied into a ring of two shared
                  stages by TMA bulk copy (cp.async.bulk + mbarrier),
                  issued by the CTA's thread 0 once its next ticket is
                  back, the stage then the tile's word buffer;
  producer_warp   the same ring filled by a producer warp beside the 256
                  packing threads, which takes a tile's ticket once the
                  packers have begun the tile before it.

Every design is built by its own process (into its copy's ``build/``),
held bitwise against ``hufenc_plain`` and timed L2-cold
(``chip_smoke.cold_device_ms``: the memset and the kernel of one call)
at the staged route's calls of phases T.A (CESM 1800x3600 at rel 1e-4)
and T.E (NWChem 2^23 value-direct at rel 1e-3) of chip_smoke.py, in
turns, ``--reps`` rounds. Prints one JSON line a (design, round) and the
card's name and power limit.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "hufenc_designs")
KERNEL = "__global__ void __launch_bounds__(THREADS, GP_CTAS_PER_SM)\nhufenc_kernel("
PREFETCH = "      // the next tile into the L2"

TMA_RING = r'''constexpr int HE_STAGE = GP_TILE + 4;   // a tile's codes from word a in 0..3

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A tile's layout in its stage: codes[t0 + i] lies at stage[a + i], where
// 4a is the byte offset of codes + t0 in its 16-byte line; [h, e) is the
// part copied in bulk (16-byte aligned at both ends), the rest is read by
// plain loads.
struct HeTile {
  int n, a, h, e;
};

__device__ __forceinline__ HeTile he_tile(const int32_t* codes, int64_t n,
                                          int64_t t0) {
  HeTile t;
  t.n = static_cast<int>(min(static_cast<int64_t>(GP_TILE), n - t0));
  t.a = static_cast<int>((reinterpret_cast<uintptr_t>(codes + t0) >> 2) & 3);
  t.h = min((4 - t.a) & 3, t.n);
  t.e = t.h + ((t.n - t.h) & ~3);
  return t;
}

// One thread: the bulk copy of tile `tile`'s aligned body into `stage`,
// completing on `bar` (an arrival that expects the copy's bytes; a body of
// no bytes is an arrival alone).
__device__ __forceinline__ void he_issue(const int32_t* codes, int64_t n,
                                         int64_t tile, int32_t* stage,
                                         unsigned long long* bar) {
  const int64_t t0 = tile * GP_TILE;
  const HeTile t = he_tile(codes, n, t0);
  const uint32_t b = smem_u32(bar);
  const uint32_t bytes = static_cast<uint32_t>(4 * (t.e - t.h));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(stage + t.a + t.h)),
           "l"(reinterpret_cast<uintptr_t>(codes + t0 + t.h)),
           "r"(bytes), "r"(b) : "memory");
}

__device__ __forceinline__ void he_wait(unsigned long long* bar,
                                        uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "HE_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra HE_WAIT;\n}"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The run of GP_PER symbols from tile index i0 on into sym[] (clamped
// code, length in the high half; 0 past the tile's n symbols) -> the
// run's bits: from the stage (four 16-byte vectors where the stage is
// aligned and the run lies in the bulk-copied part), else symbol by
// symbol from the stage or, outside [h, e), from the stream.
__device__ __forceinline__ int32_t he_load_run(const int32_t* codes,
                                               int64_t t0, const HeTile& t,
                                               const int32_t* stage,
                                               const int32_t* ln, int i0,
                                               int32_t* sym) {
  int32_t bits = 0;
  if (t.a == 0 && i0 + GP_PER <= t.e) {
    const int4* s4 = reinterpret_cast<const int4*>(stage + i0);
#pragma unroll
    for (int k = 0; k < GP_PER / 4; ++k) {
      const int4 v = s4[k];
      const int32_t cs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int code = clamp_code(cs[j]);
        const int32_t l = ln[code];
        sym[4 * k + j] = code | (l << 16);
        bits += l;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < GP_PER; ++i) {
      const int j = i0 + i;
      int32_t l = 0, code = 0;
      if (j < t.n) {
        code = clamp_code(j >= t.h && j < t.e ? stage[t.a + j]
                                              : __ldg(codes + t0 + j));
        l = ln[code];
      }
      sym[i] = code | (l << 16);
      bits += l;
    }
  }
  return bits;
}

__global__ void __launch_bounds__(THREADS, GP_CTAS_PER_SM)
hufenc_kernel(const int32_t* __restrict__ codes, int64_t n,
              const int32_t* __restrict__ lengths,
              const int32_t* __restrict__ cwords, int64_t bs, int64_t tiles,
              int64_t w32, uint32_t* words, int32_t* block_nbits,
              unsigned long long* status, unsigned long long* ticket) {
  __shared__ int32_t ln[NUM_SYMBOLS];
  __shared__ uint32_t cw[NUM_SYMBOLS];
  __shared__ __align__(16) int32_t stage[2][HE_STAGE];
  __shared__ __align__(8) unsigned long long bar[2];
  __shared__ int32_t pre[THREADS + 1];    // the runs' tile-local first bits
  __shared__ int64_t s_cur;
  __shared__ int64_t part[2 * GP_LOOK * (THREADS / 32)];
  __shared__ unsigned has[2 * GP_LOOK * (THREADS / 32)];
  const int tid = threadIdx.x;
  const int i0 = tid * GP_PER;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const int64_t first = static_cast<int64_t>(atomicAdd(ticket, 1ull));
    if (first < tiles) he_issue(codes, n, first, stage[0], bar);
    s_cur = first;
  }
  for (int s = tid; s < NUM_SYMBOLS; s += THREADS) {
    ln[s] = lengths[s];
    cw[s] = static_cast<uint32_t>(cwords[s]);
  }
  __syncthreads();                         // the book, the barriers
  for (int it = 0;; ++it) {
    const int64_t tile = s_cur;
    if (tile >= tiles) break;
    const int s = it & 1;
    unsigned long long later = 0;
    if (tid == 0) later = atomicAdd(ticket, 1ull);
    const int64_t t0 = tile * GP_TILE;
    const HeTile t = he_tile(codes, n, t0);
    he_wait(bar + s, (it >> 1) & 1);      // this stage's (it/2)-th copy

    int32_t sym[GP_PER];
    const int32_t mybits = he_load_run(codes, t0, t, stage[s], ln, i0, sym);
    int32_t total;
    const int32_t before = block_exclusive_scan(mybits, &total);
    pre[tid] = before;
    if (tid == 0) {
      if (static_cast<int64_t>(later) < tiles)
        he_issue(codes, n, static_cast<int64_t>(later), stage[s ^ 1],
                 bar + (s ^ 1));
      pre[THREADS] = total;
      gp_publish<false>(status + tile, (tile == 0 ? ST_PRE : ST_AGG)
                                    | static_cast<unsigned long long>(total));
    }
    // every run is in registers: the stage becomes the tile's buffer
    uint32_t* buf = reinterpret_cast<uint32_t*>(stage[s]);
    gp_zero_edges(buf, before, before + mybits);
    __syncthreads();
    gp_compose(sym, cw, before, mybits, buf);
    if (tid == 0) s_cur = static_cast<int64_t>(later);
    __syncthreads();                       // the buffer, the runs' places
    const int64_t s0 = gp_look_back(status, tile, part, has);
    if (tid == 0 && tile > 0)
      gp_publish<false>(status + tile,
                 ST_PRE | static_cast<unsigned long long>(s0 + total));
    gp_block_bits(pre, sym, t0, i0, t.n, before, bs, block_nbits);
    gp_write_out(buf, s0, total, words, w32);
    // this thread's writes to the stage, before its next bulk copy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();                       // the tile is out
  }
}

'''

PRODUCER_WARP = r'''constexpr int HE_STAGE = GP_TILE + 4;   // a tile's codes from word a in 0..3
constexpr int HE_THREADS = THREADS + 32;   // the packers, the producer warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A tile's layout in its stage: codes[t0 + i] lies at stage[a + i], where
// 4a is the byte offset of codes + t0 in its 16-byte line; [h, e) is the
// part copied in bulk (16-byte aligned at both ends), the rest is read by
// plain loads.
struct HeTile {
  int n, a, h, e;
};

__device__ __forceinline__ HeTile he_tile(const int32_t* codes, int64_t n,
                                          int64_t t0) {
  HeTile t;
  t.n = static_cast<int>(min(static_cast<int64_t>(GP_TILE), n - t0));
  t.a = static_cast<int>((reinterpret_cast<uintptr_t>(codes + t0) >> 2) & 3);
  t.h = min((4 - t.a) & 3, t.n);
  t.e = t.h + ((t.n - t.h) & ~3);
  return t;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits for the completion of `bar`'s phase of the given parity.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "HE_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra HE_WAIT;\n}"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The producer: tile `tile`'s aligned body into `stage` by one bulk copy
// completing on `bar` (an arrival that expects the copy's bytes; a body
// of no bytes is an arrival alone).
__device__ __forceinline__ void he_issue(const int32_t* codes, int64_t n,
                                         int64_t tile, int32_t* stage,
                                         unsigned long long* bar) {
  const int64_t t0 = tile * GP_TILE;
  const HeTile t = he_tile(codes, n, t0);
  const uint32_t b = smem_u32(bar);
  const uint32_t bytes = static_cast<uint32_t>(4 * (t.e - t.h));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(stage + t.a + t.h)),
           "l"(reinterpret_cast<uintptr_t>(codes + t0 + t.h)),
           "r"(bytes), "r"(b) : "memory");
}

// The run of GP_PER symbols from tile index i0 on into sym[] (clamped
// code, length in the high half; 0 past the tile's n symbols) -> the
// run's bits: from the stage (four 16-byte vectors where the stage is
// aligned and the run lies in the bulk-copied part), else symbol by
// symbol from the stage or, outside [h, e), from the stream.
__device__ __forceinline__ int32_t he_load_run(const int32_t* codes,
                                               int64_t t0, const HeTile& t,
                                               const int32_t* stage,
                                               const int32_t* ln, int i0,
                                               int32_t* sym) {
  int32_t bits = 0;
  if (t.a == 0 && i0 + GP_PER <= t.e) {
    const int4* s4 = reinterpret_cast<const int4*>(stage + i0);
#pragma unroll
    for (int k = 0; k < GP_PER / 4; ++k) {
      const int4 v = s4[k];
      const int32_t cs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int code = clamp_code(cs[j]);
        const int32_t l = ln[code];
        sym[4 * k + j] = code | (l << 16);
        bits += l;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < GP_PER; ++i) {
      const int j = i0 + i;
      int32_t l = 0, code = 0;
      if (j < t.n) {
        code = clamp_code(j >= t.h && j < t.e ? stage[t.a + j]
                                              : __ldg(codes + t0 + j));
        l = ln[code];
      }
      sym[i] = code | (l << 16);
      bits += l;
    }
  }
  return bits;
}

__global__ void __launch_bounds__(HE_THREADS, GP_CTAS_PER_SM)
hufenc_kernel(const int32_t* __restrict__ codes, int64_t n,
              const int32_t* __restrict__ lengths,
              const int32_t* __restrict__ cwords, int64_t bs, int64_t tiles,
              int64_t w32, uint32_t* words, int32_t* block_nbits,
              unsigned long long* status, unsigned long long* ticket) {
  __shared__ int32_t ln[NUM_SYMBOLS];
  __shared__ uint32_t cw[NUM_SYMBOLS];
  __shared__ __align__(16) int32_t stage[2][HE_STAGE];
  __shared__ __align__(8) unsigned long long full[2], empty[2], go;
  __shared__ int64_t slot[2];             // the tile in each stage
  __shared__ int32_t pre[THREADS + 1];    // the runs' tile-local first bits
  __shared__ int64_t part[2 * GP_LOOK * (THREADS / 32)];
  __shared__ unsigned has[2 * GP_LOOK * (THREADS / 32)];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s);
      mbar_init(empty + s);
    }
    mbar_init(&go);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int s = tid; s < NUM_SYMBOLS; s += HE_THREADS) {
    ln[s] = lengths[s];
    cw[s] = static_cast<uint32_t>(cwords[s]);
  }
  __syncthreads();                         // the book, the barriers

  if (tid >= THREADS) {                    // the producer warp
    if (tid != THREADS) return;
    for (int k = 0;; ++k) {
      const int s = k & 1;
      if (k >= 1) mbar_wait(&go, (k - 1) & 1);
      if (k >= 2) mbar_wait(empty + s, ((k >> 1) - 1) & 1);
      const int64_t tile = static_cast<int64_t>(atomicAdd(ticket, 1ull));
      slot[s] = tile;
      if (tile >= tiles) {
        mbar_arrive(full + s);             // the packers' last wait
        return;
      }
      he_issue(codes, n, tile, stage[s], full + s);
    }
  }

  const int i0 = tid * GP_PER;
  for (int it = 0;; ++it) {
    const int s = it & 1;
    mbar_wait(full + s, (it >> 1) & 1);    // this stage's (it/2)-th fill
    const int64_t tile = slot[s];
    if (tile >= tiles) break;
    if (tid == 0) mbar_arrive(&go);
    const int64_t t0 = tile * GP_TILE;
    const HeTile t = he_tile(codes, n, t0);

    int32_t sym[GP_PER];
    const int32_t mybits = he_load_run(codes, t0, t, stage[s], ln, i0, sym);
    int32_t total;
    const int32_t before = block_exclusive_scan(mybits, &total);
    pre[tid] = before;
    if (tid == 0) {
      pre[THREADS] = total;
      gp_publish<false>(status + tile,
                        (tile == 0 ? ST_PRE : ST_AGG)
                            | static_cast<unsigned long long>(total));
    }
    // every run is in registers: the stage becomes the tile's buffer
    uint32_t* buf = reinterpret_cast<uint32_t*>(stage[s]);
    gp_zero_edges(buf, before, before + mybits);
    asm volatile("bar.sync 1, 256;" ::: "memory");
    gp_compose(sym, cw, before, mybits, buf);
    asm volatile("bar.sync 1, 256;" ::: "memory");                     // the buffer, the runs' places
    const int64_t s0 = gp_look_back(status, tile, part, has);
    if (tid == 0 && tile > 0)
      gp_publish<false>(status + tile,
                        ST_PRE | static_cast<unsigned long long>(s0 + total));
    gp_block_bits(pre, sym, t0, i0, t.n, before, bs, block_nbits);
    gp_write_out(buf, s0, total, words, w32);
    // this thread's accesses to the stage, before the producer's next
    // copy into it; then the stage goes back to the producer
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (tid == 0) mbar_arrive(empty + s);
  }
}

'''


def _replace_kernel(src, new):
    a = src.index(KERNEL)
    b = src.index("}  // namespace", a)
    return src[:a] + new + src[b:]


def _no_prefetch(src):
    a = src.index(PREFETCH)
    b = src.index("    }\n    gp_zero_edges(buf, before, before + mybits);", a)
    return src[:a] + src[b:]


def _fenced(src):
    a = src.index(KERNEL)
    return src[:a] + src[a:].replace("gp_publish<false>(", "gp_publish<true>(")


def _producer_warp(src):
    # the scan and the look-back sync the 256 packers alone (named
    # barrier 1; gather_pack_kernel's 256-thread CTAs sync the same way)
    for fn in ("__device__ int32_t block_exclusive_scan(",
               "__device__ __forceinline__ int64_t gp_look_back("):
        a = src.index(fn)
        b = src.index("\n}\n", a)
        src = src[:a] + src[a:b].replace(
            "__syncthreads();",
            'asm volatile("bar.sync 1, 256;" ::: "memory");') + src[b:]
    src = _replace_kernel(src, PRODUCER_WARP)
    old = "                    THREADS, 0, st>>>(\n        static_cast<const int32_t*>(codes), n,"
    assert old in src
    return src.replace(old, old.replace("THREADS, 0", "HE_THREADS, 0"))


DESIGNS = {
    "final": lambda s: s,
    "no_prefetch": _no_prefetch,
    "fenced": _fenced,
    "fenced_no_prefetch": lambda s: _fenced(_no_prefetch(s)),
    "tma_ring": lambda s: _replace_kernel(s, TMA_RING),
    "producer_warp": _producer_warp,
}


def make(design):
    """The design's copy of src/repro_torch -> its src directory."""
    dst = os.path.join(OUT, design, "src")
    shutil.rmtree(os.path.join(OUT, design), ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(dst, "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "repro_torch", "csrc", "hufenc.cu")
    with open(path) as f:
        src = f.read()
    new = DESIGNS[design](src)
    assert design == "final" or new != src, design
    with open(path, "w") as f:
        f.write(new)
    return dst


def time_design(src, design, rnd):
    """In this process: the design's row-7 calls of T.A and T.E, held
    bitwise and timed L2-cold (three calls of cold_device_ms each)."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, src)
    import chip_smoke as CS
    import repro_torch
    from repro_torch.core import CEAZ, CEAZConfig, default_offline_codebook
    from repro_torch.data import fields as F
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.hufenc import ops as HE
    assert repro_torch.__file__.startswith(src)
    _build.library()
    captured = {}
    flat = dispatch.resolve("hufenc_flat", "cuda", "cuda")

    def record(*a):
        captured.setdefault("args", a)
        return flat(*a)
    dispatch.register("hufenc_flat", "cuda", lambda: record)
    offline = default_offline_codebook()
    out = dict(design=design, round=rnd)
    for phase, x, kw in (("T.A", F.cesm_proxy(size="medium"), dict(eb=1e-4)),
                         ("T.E", F.nwchem_proxy(size="medium"),
                          dict(eb=1e-3, predictor="none"))):
        captured.clear()
        CEAZ(CEAZConfig(device="cuda", mode="rel", use_fused=False, **kw),
             offline_codebook=offline).compress(x)
        args = captured["args"]
        CS.check(CS.same_outputs(HE.hufenc_cuda(*args),
                                 HE.hufenc_plain(*args)),
                 f"{design} disagrees with hufenc_plain at {phase}")
        out[phase] = [CS.cold_device_ms(lambda: HE.hufenc_cuda(*args))
                      for _ in range(3)]
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--designs", default=",".join(DESIGNS))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--time", nargs=3, metavar=("SRC", "DESIGN", "ROUND"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        time_design(args.time[0], args.time[1], int(args.time[2]))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("hufenc_designs: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    designs = args.designs.split(",")
    srcs = {d: make(d) for d in designs}
    rc = 0
    for rnd in range(args.reps):
        for d in designs:
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--time", srcs[d], d, str(rnd)],
                                 timeout=600)
            rc = rc or res.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
