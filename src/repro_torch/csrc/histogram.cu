// Per-row 1024-bin histogram of quant codes.
//
// Replaces the TPU kernel src/repro/kernels/histogram/kernel.py::histogram
// (:39; pallas_call at :43, _hist_kernel at :24), generalised from one
// row to C rows (codes2 (C, n) int32, valid2 (C, n) bool -> (C, 1024)
// int32): both callers want per-chunk counts.
//
// The TPU kernel sums one-hot compares over (8, 512) tiles into ONE output
// block that its sequential grid carries from step to step. Hopper's grid
// runs in no order, so each CTA counts a slice of a row in shared memory
// and then adds its non-zero bins into the row's output with integer
// atomics (exact, order-free). A code outside [0, 1024) or at an invalid
// position counts nowhere, as the TPU kernel's one-hot compare drops its
// -1 padding sentinel.
//
// Bound on the H100: bytes — each value is read once (4 B code, 1 B flag)
// and 4 KB a row are written. What the design does about each thing that
// stands between a launch and that bound:
//   * the grid: the wrapper sizes the slice a CTA counts from C*n
//     (kernels/histogram/ops.py::histogram_grid): about 4 CTAs an SM
//     where the data allows it, at least 4096 values a CTA. One 2^15-value
//     chunk of the staged route then runs on 8 SMs, not 2, and a 2^17 row
//     on 32;
//   * the loads: a thread reads 4 consecutive codes as one 16-byte vector
//     and their 4 flags as one 4-byte word, 4 vectors in flight (scalar
//     at an unaligned head and tail: a row starts at 4*c*n bytes);
//   * the hot bin: quant codes pile up at RADIUS=512 on smooth fields,
//     and shared atomics on one address serialise. Every warp counts into
//     a 1024-bin table of its own (8 x 4 KB), and every thread keeps a
//     (code, count) run in registers that costs one atomic when its code
//     changes, not one a value (the runs replace the first design's
//     __match_any_sync merge of equal codes a warp step). The warps'
//     tables are summed at the end.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NUM_SYMBOLS = 1024;
constexpr int MAX_GRID_Y = 65535;
constexpr int IN_FLIGHT = 4;          // 16-byte vectors a thread loads at once

// One value into the thread's run: an equal code extends it, another
// code flushes it into the warp's table.
__device__ __forceinline__ void count(int32_t* hw, int32_t code, uint32_t ok,
                                      int32_t& last, int32_t& run) {
  if (!ok || static_cast<uint32_t>(code) >= NUM_SYMBOLS) return;
  if (code == last) {
    ++run;
    return;
  }
  if (run) atomicAdd(hw + last, run);
  last = code;
  run = 1;
}

__device__ __forceinline__ void count4(int32_t* hw, int4 v, uint32_t f,
                                       int32_t& last, int32_t& run) {
  count(hw, v.x, f & 0xffu, last, run);
  count(hw, v.y, (f >> 8) & 0xffu, last, run);
  count(hw, v.z, (f >> 16) & 0xffu, last, run);
  count(hw, v.w, f >> 24, last, run);
}

__global__ void __launch_bounds__(THREADS)
histogram_kernel(const int32_t* __restrict__ codes,
                 const uint8_t* __restrict__ valid, int64_t C, int64_t n,
                 int64_t per, int32_t* out) {
  __shared__ __align__(16) int32_t h[WARPS * NUM_SYMBOLS];
  const int tid = threadIdx.x;
  int32_t* hw = h + (tid >> 5) * NUM_SYMBOLS;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t end = min(start + per, n);
  for (int64_t c = blockIdx.y; c < C; c += gridDim.y) {
    for (int s = tid; s < WARPS * NUM_SYMBOLS / 4; s += THREADS)
      reinterpret_cast<int4*>(h)[s] = make_int4(0, 0, 0, 0);
    __syncthreads();
    int32_t last = -1, run = 0;
    const int64_t g0 = c * n + start, g1 = c * n + end;
    // [a0, a1): the whole 16-byte code vectors of the slice; their flags
    // are 4-byte aligned too unless a caller passed offset views
    const int64_t skew = (reinterpret_cast<uintptr_t>(codes + g0) >> 2) & 3;
    const int64_t a0 = min(g0 + ((4 - skew) & 3), g1);
    const int64_t a1 = a0 + ((g1 - a0) & ~static_cast<int64_t>(3));
    if ((reinterpret_cast<uintptr_t>(valid + a0) & 3) == 0) {
      if (tid < a0 - g0) count(hw, codes[g0 + tid], valid[g0 + tid], last, run);
      if (tid < g1 - a1) count(hw, codes[a1 + tid], valid[a1 + tid], last, run);
      const int4* c4 = reinterpret_cast<const int4*>(codes + a0);
      const uint32_t* f4 = reinterpret_cast<const uint32_t*>(valid + a0);
      const int64_t nv = (a1 - a0) >> 2;
      for (int64_t k0 = tid; k0 < nv; k0 += IN_FLIGHT * THREADS) {
        int4 x[IN_FLIGHT];
        uint32_t f[IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u) {
          const int64_t k = k0 + u * THREADS;
          f[u] = 0;
          x[u] = make_int4(0, 0, 0, 0);
          if (k < nv) {
            x[u] = __ldg(c4 + k);
            f[u] = __ldg(f4 + k);
          }
        }
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u) count4(hw, x[u], f[u], last, run);
      }
    } else {
      for (int64_t i = g0 + tid; i < g1; i += THREADS)
        count(hw, codes[i], valid[i], last, run);
    }
    if (run) atomicAdd(hw + last, run);
    __syncthreads();
    for (int s = tid; s < NUM_SYMBOLS; s += THREADS) {
      int32_t sum = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += h[w * NUM_SYMBOLS + s];
      if (sum != 0) atomicAdd(out + c * NUM_SYMBOLS + s, sum);
    }
    __syncthreads();
  }
}

}  // namespace

// Zeroes out (C, 1024) on the stream, then counts into it. The grid is
// (ceil(n/per), grid_y): CTA x counts the values [x*per, (x+1)*per) of
// rows y, y+grid_y, ... (grid_y <= 65535, CUDA's limit).
extern "C" int ceaz_histogram(const void* codes, const void* valid, int64_t C,
                              int64_t n, int64_t per, int64_t grid_y,
                              void* out, void* stream) {
  if (C > 0 && n > 0) {
    if (per <= 0 || grid_y <= 0 || grid_y > MAX_GRID_Y
        || (n + per - 1) / per > INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(out, 0, C * NUM_SYMBOLS * 4, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(static_cast<unsigned>((n + per - 1) / per),
              static_cast<unsigned>(grid_y));
    histogram_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(valid),
        C, n, per, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
