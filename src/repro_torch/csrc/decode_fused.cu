// Decode megakernel: table walk + rank-gather outlier patch + inverse
// dual-quant for chunk rows of at most 2^17 values.
//
// Replaces the TPU kernel src/repro/kernels/megakernel/decode_kernel.py::
// ceaz_chunk_dec_fused (:146). That kernel carries the Lorenzo segment
// sum from one chunk row to the next through a revisited (1, 1) block on
// the TPU's sequential grid; CUDA blocks run in no order, so the carry
// is split out, composed exactly as ref.patch_and_inverse
// (src/repro/kernels/megakernel/ref.py:181-185) composes it:
//   rows_kernel  — one CTA per chunk row: each thread walks its blocks
//                  (walk.cuh) into the output row, counting escape codes;
//                  a scan of those counts gives every block its first
//                  outlier rank; each thread then patches its blocks
//                  (code 0 takes the r-th stored delta, r clamped into
//                  [0, Ko-1]) and writes the in-block inclusive prefix
//                  (Lorenzo rows) or delta + base (value rows); a scan of
//                  the block sums gives each block's row offset and the
//                  row's total;
//   torch glue   — the segmented exclusive scan of the row totals,
//                  resetting at seg0 (the wrapper);
//   add_kernel   — adds block offset + segment carry to every valid
//                  position of the Lorenzo rows.
// Every prefix sum and carry runs in uint32 and is reinterpreted: signed
// overflow is undefined in C++, and the reference relies on int32 wrap.
//
// Bound on the H100: latency, as the walk kernel (hufdec.cu): each lane
// runs block_size dependent table steps, then re-reads its block once
// for the patch. Design: the row's decoded codes never leave the output
// row (patched in place), so the kernel moves ~3 passes of 4 B/value.
#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

constexpr int RADIUS = 512;

__global__ void rows_kernel(const uint32_t* __restrict__ words, int64_t W,
                            const int32_t* __restrict__ lane_start,
                            const int32_t* __restrict__ counts,
                            const int32_t* __restrict__ table,
                            const int32_t* __restrict__ cb_idx,
                            const int32_t* __restrict__ odelta, int64_t Ko,
                            const int32_t* __restrict__ base,
                            const int32_t* __restrict__ islor, int64_t NB,
                            int32_t bs, int32_t* out, int32_t* scratch,
                            int32_t* row_sum) {
  int64_t c = blockIdx.x;
  int64_t N = NB * bs;
  int32_t* orow = out + c * N;
  int32_t* zoff = scratch + c * 2 * NB;  // escape counts -> first ranks
  uint32_t* boff = reinterpret_cast<uint32_t*>(scratch + c * 2 * NB + NB);
  const int32_t* tbl = table + static_cast<int64_t>(cb_idx[c]) * ceaz::TBL;
  int64_t count = counts[c];
  bool lor = islor[c] != 0;
  uint32_t b0 = static_cast<uint32_t>(base[c]);

  for (int64_t b = threadIdx.x; b < NB; b += blockDim.x) {
    int64_t cnt64 = count - b * bs;
    int32_t cnt = static_cast<int32_t>(cnt64 < 0 ? 0 : (cnt64 > bs ? bs : cnt64));
    zoff[b] = ceaz::walk_lane(words + c * W, W, 0, W, lane_start[c * NB + b],
                              tbl, cnt, bs, orow + b * bs);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t run = 0;
    for (int64_t b = 0; b < NB; ++b) {
      int32_t z = zoff[b];
      zoff[b] = run;
      run += z;
    }
  }
  __syncthreads();
  for (int64_t b = threadIdx.x; b < NB; b += blockDim.x) {
    int64_t cnt64 = count - b * bs;
    int32_t cnt = static_cast<int32_t>(cnt64 < 0 ? 0 : (cnt64 > bs ? bs : cnt64));
    int64_t rank = zoff[b];
    uint32_t local = 0;
    int32_t* blk = orow + b * bs;
    for (int32_t i = 0; i < cnt; ++i) {
      int32_t code = blk[i];
      uint32_t d;
      if (code == 0) {
        int64_t r = rank < 0 ? 0 : (rank >= Ko ? Ko - 1 : rank);
        d = static_cast<uint32_t>(odelta[c * Ko + r]);
        ++rank;
      } else {
        d = static_cast<uint32_t>(code - RADIUS);
      }
      local += d;
      blk[i] = static_cast<int32_t>(lor ? local : d + b0);
    }
    boff[b] = local;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t run = 0;
    for (int64_t b = 0; b < NB; ++b) {
      uint32_t s = boff[b];
      boff[b] = run;
      run += s;
    }
    row_sum[c] = static_cast<int32_t>(run);
  }
}

__global__ void add_kernel(const int32_t* __restrict__ counts,
                           const int32_t* __restrict__ islor,
                           const int32_t* __restrict__ scratch,
                           const int32_t* __restrict__ carry, int64_t NB,
                           int32_t bs, int32_t* out) {
  int64_t c = blockIdx.y;
  if (islor[c] == 0) return;
  int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= counts[c] || p >= NB * bs) return;
  const uint32_t* boff =
      reinterpret_cast<const uint32_t*>(scratch + c * 2 * NB + NB);
  int32_t* q = out + c * NB * bs + p;
  *q = static_cast<int32_t>(static_cast<uint32_t>(*q) + boff[p / bs] +
                            static_cast<uint32_t>(carry[c]));
}

}  // namespace

// scratch: (C, 2*NB) int32; row_sum: (C,) int32. out is fully written.
extern "C" int ceaz_dec_rows(const void* words, int64_t C, int64_t W,
                             const void* lane_start, const void* counts,
                             const void* table, const void* cb_idx,
                             const void* odelta, int64_t Ko, const void* base,
                             const void* islor, int64_t NB, int64_t bs,
                             void* out, void* scratch, void* row_sum,
                             void* stream) {
  if (C > 0 && NB > 0) {
    int64_t t = (NB + 31) / 32 * 32;
    int threads = static_cast<int>(t < 256 ? t : 256);
    rows_kernel<<<static_cast<unsigned>(C), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), W,
        static_cast<const int32_t*>(lane_start),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(table),
        static_cast<const int32_t*>(cb_idx),
        static_cast<const int32_t*>(odelta), Ko,
        static_cast<const int32_t*>(base), static_cast<const int32_t*>(islor),
        NB, static_cast<int32_t>(bs), static_cast<int32_t*>(out),
        static_cast<int32_t*>(scratch), static_cast<int32_t*>(row_sum));
  }
  return static_cast<int>(cudaGetLastError());
}

// carry: (C,) int32, the segmented exclusive scan of row_sum.
extern "C" int ceaz_dec_add(const void* counts, const void* islor,
                            const void* scratch, const void* carry, int64_t C,
                            int64_t NB, int64_t bs, void* out, void* stream) {
  if (C > 0 && NB > 0) {
    constexpr int THREADS = 256;
    dim3 grid(static_cast<unsigned>((NB * bs + THREADS - 1) / THREADS),
              static_cast<unsigned>(C));
    add_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(counts), static_cast<const int32_t*>(islor),
        static_cast<const int32_t*>(scratch),
        static_cast<const int32_t*>(carry), NB, static_cast<int32_t>(bs),
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
