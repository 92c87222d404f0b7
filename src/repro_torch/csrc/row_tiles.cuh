// Row tiles, shared by center.cu and bank.cu.
//
// A launch over C rows of V values cuts every row into S = ceil(V / tile)
// tiles and numbers them flat, t = c * S + segment, so any row count fits
// one launch: bank.cu runs a CTA a tile (t = blockIdx.x). center.cu runs
// a resident grid of as many CTAs as fit on the card at once, CTA b of G
// taking the contiguous tiles [T*b/G, T*(b+1)/G) (cta_span, run_end) and
// adding their sums in shared memory before it publishes each row once.
// A per-row ticket (an atomicAdd of the tiles published, after a
// __threadfence) names the CTA that publishes a row's last tile; that CTA
// finishes the row. No CTA waits on another, so the grid needs no
// co-residency.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ceaz {

// CTAs of a launch of `kernel` (`threads` a CTA) over `tiles` tiles: as
// many as fit on the card at once, or fewer tiles. `fit` caches the
// card's count for the kernel.
inline int64_t resident_ctas(const void* kernel, int threads, int64_t tiles,
                             int64_t* fit) {
  if (*fit == 0) {
    int dev = 0, sms = 132, per = 1;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                         threads, 0)
               != cudaSuccess
        || per < 1) {
      sms = 132;
      per = 1;
    }
    *fit = static_cast<int64_t>(sms) * per;
  }
  return tiles < *fit ? tiles : *fit;
}

// This CTA's tiles [*t0, *t1) of `tiles`.
__device__ __forceinline__ void cta_span(int64_t tiles, int64_t* t0,
                                         int64_t* t1) {
  *t0 = tiles * blockIdx.x / gridDim.x;
  *t1 = tiles * (blockIdx.x + 1) / gridDim.x;
}

// The end of the run of tiles from r0 that lie in r0's row and in this
// CTA's span [.., t1), S tiles a row.
__device__ __forceinline__ int64_t run_end(int64_t r0, int64_t t1,
                                           int64_t S) {
  int64_t end = (r0 / S + 1) * S;
  return end < t1 ? end : t1;
}

// After this CTA's atomics for row c's `run` tiles: the ticket, true in
// every thread of the CTA that publishes the row's last tile (the others
// of the launch have published theirs, and a __threadfence after the
// ticket makes their sums visible to __ldcg). `flag` is shared.
__device__ __forceinline__ bool last_of_row(int32_t* tickets, int64_t c,
                                            int64_t run, int64_t S,
                                            int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(tickets + c, static_cast<int32_t>(run)) + run == S;
  __syncthreads();
  bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace ceaz
