// Per-row 1024-bin histogram of quant codes.
//
// Replaces the TPU kernel src/repro/kernels/histogram/kernel.py::histogram
// (:39; pallas_call at :43, _hist_kernel at :24), generalised from one
// row to C rows (codes2 (C, n) int32, valid2 (C, n) bool -> (C, 1024)
// int32): both callers want per-chunk counts.
//
// The TPU kernel sums one-hot compares over (8, 512) tiles into ONE output
// block that its sequential grid carries from step to step. Hopper's grid
// runs in no order, so each CTA counts its slice of a row into a shared-
// memory sub-histogram and then adds its non-zero bins into the row's
// output with integer atomics (exact, order-free). A code outside
// [0, 1024) or at an invalid position counts nowhere, as the TPU kernel's
// one-hot compare drops its -1 padding sentinel.
//
// Bound on the H100: bytes — each value is read once (4 B code, 1 B flag)
// and 4 KB a row are written. Quant codes pile up at RADIUS=512 on smooth
// fields, and shared-memory atomics on one address serialise, so a warp
// first merges equal codes with __match_any_sync: one atomic per distinct
// code a warp step instead of one per lane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NUM_SYMBOLS = 1024;
constexpr int64_t PER_CTA = 16384;   // values of one row a CTA counts
constexpr int MAX_GRID_Y = 65535;

__global__ void histogram_kernel(const int32_t* __restrict__ codes,
                                 const uint8_t* __restrict__ valid,
                                 int64_t C, int64_t n, int32_t* out) {
  __shared__ int32_t h[NUM_SYMBOLS];
  int lane = threadIdx.x & 31;
  int64_t start = static_cast<int64_t>(blockIdx.x) * PER_CTA;
  int64_t end = min(start + PER_CTA, n);
  for (int64_t c = blockIdx.y; c < C; c += gridDim.y) {
    for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS) h[s] = 0;
    __syncthreads();
    const int32_t* crow = codes + c * n;
    const uint8_t* vrow = valid + c * n;
    // the loop bound is uniform across the CTA, so every lane of a warp
    // reaches each __match_any_sync
    for (int64_t i0 = start; i0 < end; i0 += THREADS) {
      int64_t i = i0 + threadIdx.x;
      int key = -1;
      if (i < end && vrow[i]) {
        int32_t v = crow[i];
        if (v >= 0 && v < NUM_SYMBOLS) key = v;
      }
      unsigned peers = __match_any_sync(0xffffffffu, key);
      if (key >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&h[key], __popc(peers));
    }
    __syncthreads();
    for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS)
      if (h[s] != 0) atomicAdd(out + c * NUM_SYMBOLS + s, h[s]);
    __syncthreads();
  }
}

}  // namespace

// out (C, 1024) must be zeroed by the caller.
extern "C" int ceaz_histogram(const void* codes, const void* valid, int64_t C,
                              int64_t n, void* out, void* stream) {
  if (C > 0 && n > 0) {
    dim3 grid(static_cast<unsigned>((n + PER_CTA - 1) / PER_CTA),
              static_cast<unsigned>(C < MAX_GRID_Y ? C : MAX_GRID_Y));
    histogram_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(valid),
        C, n, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
