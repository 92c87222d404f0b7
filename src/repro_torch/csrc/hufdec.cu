// Block-parallel canonical-Huffman table walks: two entries.
//
// ceaz_hufdec_tiles replaces the TPU kernel
// src/repro/kernels/megakernel/decode_kernel.py::hufdec_tiles (:246). It
// decodes chunks too large for the decode megakernel (more than 2^17
// values per row): one thread per (chunk, block) lane walks its block's
// symbols (walk.cuh). Each lane reads inside its tile's word window —
// tiles of 2^15/block_size blocks, windows placed by the wrapper from the
// cumulative block bit counts, exactly as the TPU kernel's
// scalar-prefetched offsets — so the output matches the reference even
// on corrupted payloads.
//
// ceaz_hufdec replaces the TPU kernel src/repro/kernels/hufdec/kernel.py::
// hufdec (:85), the walk of the split decode route. The TPU runs one
// program per chunk with the chunk's blocks as vector lanes and the row
// and its decode table in VMEM; here one thread per (chunk, block) lane
// walks its block over the chunk's whole row (one window per row). A
// warp per CTA takes 32 consecutive lanes of one row and computes their
// first cursors itself: the exclusive prefix of the row's block bit
// counts, summed in uint32 (the reference's int32 cumsum wraps), the
// blocks before the warp by a strided sum + butterfly reduction, its own
// by a shuffle scan. One launch, no scratch.
//
// Bound on the H100: latency. A prefix code is sequential inside a
// block, so each lane runs block_size dependent steps (peek, table load
// from L2, advance); bytes moved (payload in, 4 B/value out) would take
// microseconds. A chunk of 6.48 M values has 1583 blocks: about 50 warps
// for the whole card. Design: a warp per CTA spreads the few lanes over
// as many SMs as possible; the table is read through the read-only path.
// Making it fast (several lanes per block, tables in shared memory,
// staged coalesced stores) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

constexpr int THREADS = 32;

__global__ void walk_kernel(const uint32_t* __restrict__ words, int64_t W,
                            const int32_t* __restrict__ lane_start,
                            const int32_t* __restrict__ lane_foff,
                            const int32_t* __restrict__ counts,
                            const int32_t* __restrict__ table,
                            const int32_t* __restrict__ cb_idx, int64_t NB,
                            int32_t bs, int64_t win, int32_t* out) {
  int64_t lane = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  int64_t c = blockIdx.y;
  if (lane >= NB) return;
  int64_t cnt64 = static_cast<int64_t>(counts[c]) - lane * bs;
  int32_t cnt = static_cast<int32_t>(cnt64 < 0 ? 0 : (cnt64 > bs ? bs : cnt64));
  int64_t l = c * NB + lane;
  ceaz::walk_lane(words + c * W, W, lane_foff[l], win, lane_start[l],
                  table + static_cast<int64_t>(cb_idx[c]) * ceaz::TBL, cnt, bs,
                  out + l * bs);
}

}  // namespace

extern "C" int ceaz_hufdec_tiles(const void* words, int64_t C, int64_t W,
                                 const void* lane_start, const void* lane_foff,
                                 const void* counts, const void* table,
                                 const void* cb_idx, int64_t NB, int64_t bs,
                                 int64_t win, void* out, void* stream) {
  if (C > 0 && NB > 0) {
    dim3 grid(static_cast<unsigned>((NB + THREADS - 1) / THREADS),
              static_cast<unsigned>(C));
    walk_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), W,
        static_cast<const int32_t*>(lane_start),
        static_cast<const int32_t*>(lane_foff),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(table),
        static_cast<const int32_t*>(cb_idx), NB, static_cast<int32_t>(bs), win,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

__global__ void hufdec_kernel(const uint32_t* __restrict__ words, int64_t W,
                              const int32_t* __restrict__ nbits,
                              const int32_t* __restrict__ counts,
                              const int32_t* __restrict__ table,
                              const int32_t* __restrict__ cb_idx, int64_t NB,
                              int32_t bs, int32_t* out) {
  int64_t c = blockIdx.y;
  int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS;
  int64_t lane = first + threadIdx.x;
  const int32_t* nb = nbits + c * NB;
  // bits of the row's blocks before this warp's first lane
  uint32_t before = 0;
  for (int64_t b = threadIdx.x; b < first; b += THREADS)
    before += static_cast<uint32_t>(nb[b]);
  for (int off = THREADS / 2; off > 0; off >>= 1)
    before += __shfl_xor_sync(0xffffffffu, before, off);
  // inclusive scan of the warp's own lanes
  uint32_t own = lane < NB ? static_cast<uint32_t>(nb[lane]) : 0u;
  uint32_t incl = own;
  for (int off = 1; off < THREADS; off <<= 1) {
    uint32_t v = __shfl_up_sync(0xffffffffu, incl, off);
    if (threadIdx.x >= off) incl += v;
  }
  if (lane >= NB) return;
  int32_t start = static_cast<int32_t>(before + incl - own);
  int64_t cnt64 = static_cast<int64_t>(counts[c]) - lane * bs;
  int32_t cnt = static_cast<int32_t>(cnt64 < 0 ? 0 : (cnt64 > bs ? bs : cnt64));
  ceaz::walk_lane(words + c * W, W, 0, W, start,
                  table + static_cast<int64_t>(cb_idx[c]) * ceaz::TBL, cnt, bs,
                  out + (c * NB + lane) * bs);
}

}  // namespace

extern "C" int ceaz_hufdec(const void* words, int64_t C, int64_t W,
                           const void* nbits, const void* counts,
                           const void* table, const void* cb_idx, int64_t NB,
                           int64_t bs, void* out, void* stream) {
  if (C > 0 && NB > 0) {
    dim3 grid(static_cast<unsigned>((NB + THREADS - 1) / THREADS),
              static_cast<unsigned>(C));
    hufdec_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), W,
        static_cast<const int32_t*>(nbits),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(table),
        static_cast<const int32_t*>(cb_idx), NB, static_cast<int32_t>(bs),
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
