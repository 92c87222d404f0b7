// Value-direct chunk centre: the count-aware median of each row's valid
// entries, by radix select.
//
// Replaces the TPU kernel src/repro/kernels/dualquant/kernel.py::dq_center
// (:220; pallas_call :224; per-row core _center_from_q :200 and
// _select_rank :179), which the reference also inlines into
// megakernel/kernel.py::ceaz_chunk_fused for value-direct rows.
//
// Keys are (valid ? q : INT32_MAX) ^ 0x80000000 as uint32, so the order
// of the keys is the order of the int32 values and invalid entries rank
// last. With m valid entries the two middle ranks are
// lo_i = max(m-1, 0) / 2 and hi_i = min(m / 2, V-1); selection is by
// rank, so duplicated keys give the values a sorted row holds there.
// The centre is lo + floor((hi - lo) / 2) in int32 with wrap, 0 when m
// is 0 — the reference's `lo + (hi - lo) // 2` (C's `/` truncates, so
// the floor is written out).
//
// The TPU kernel walks 8 nibble rounds over one VMEM-resident row per
// program. Here a row of up to 2^23 values spreads over many blocks and
// both ranks are selected in the same 4 passes of 8 bits:
//   (a) center_hist_kernel, grid (segments, rows): for each rank, the
//       256-bucket counts of the keys that still match the rank's
//       prefix, counted in shared memory (warp-aggregated atomics) and
//       flushed into the row's global counts with atomicAdd — integer
//       sums, so the order of the blocks does not matter. Pass 0 also
//       counts the row's valid entries;
//   (b) center_select_kernel, one block per row: each rank takes the
//       bucket its remaining rank falls in, extends its prefix by that
//       digit and subtracts the counts below; the last pass writes the
//       centre.
// Bound on the H100: bytes. Each pass reads 4 B of q and 1 B of valid
// per value (the rows are re-read from L2 or HBM in every pass); the
// work per value is a few integer operations.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t SEG = 8192;     // values per block and pass
constexpr int BUCKETS = 256;
constexpr uint32_t KEY_BIAS = 0x80000000u;
constexpr uint32_t NO_BUCKET = 0xFFFFFFFFu;
constexpr int32_t INVALID_Q = 0x7FFFFFFF;   // invalid entries rank last

// One shared-memory atomicAdd per distinct bucket of the warp (the
// whole warp calls this together; `b` is NO_BUCKET where a lane does
// not count).
__device__ __forceinline__ void warp_count(int32_t* bins, uint32_t b) {
  unsigned peers = __match_any_sync(0xffffffffu, b);
  int leader = __ffs(peers) - 1;
  if (b != NO_BUCKET && (threadIdx.x & 31) == leader)
    atomicAdd(bins + b, __popc(peers));
}

__global__ void center_hist_kernel(const int32_t* __restrict__ q,
                                   const uint8_t* __restrict__ valid,
                                   int64_t V, int shift,
                                   const int32_t* __restrict__ state,
                                   int32_t* counts, int32_t* m) {
  __shared__ int32_t bins[2 * BUCKETS];
  __shared__ int32_t n_valid;
  for (int i = threadIdx.x; i < 2 * BUCKETS; i += THREADS) bins[i] = 0;
  if (threadIdx.x == 0) n_valid = 0;
  __syncthreads();
  int64_t c = blockIdx.y;
  uint32_t pre_lo = static_cast<uint32_t>(state[c * 4 + 0]);
  uint32_t pre_hi = static_cast<uint32_t>(state[c * 4 + 2]);
  const int32_t* qr = q + c * V;
  const uint8_t* vr = valid + c * V;
  int64_t s0 = static_cast<int64_t>(blockIdx.x) * SEG;
  int64_t s1 = s0 + SEG < V ? s0 + SEG : V;
  int mine = 0;
  // every lane runs the same number of iterations (warp_count is a
  // collective); lanes past the segment count nothing
  for (int64_t base = s0; base < s1; base += THREADS) {
    int64_t i = base + threadIdx.x;
    uint32_t b_lo = NO_BUCKET, b_hi = NO_BUCKET;
    if (i < s1) {
      bool v = vr[i] != 0;
      uint32_t key = static_cast<uint32_t>(v ? qr[i] : INVALID_Q) ^ KEY_BIAS;
      mine += v ? 1 : 0;
      uint32_t digit = (key >> shift) & (BUCKETS - 1);
      bool lo_ok = shift == 24 || (key >> (shift + 8)) == (pre_lo >> (shift + 8));
      bool hi_ok = shift == 24 || (key >> (shift + 8)) == (pre_hi >> (shift + 8));
      if (lo_ok) b_lo = digit;
      if (hi_ok) b_hi = BUCKETS + digit;
    }
    warp_count(bins, b_lo);
    warp_count(bins, b_hi);
  }
  if (shift == 24 && mine) atomicAdd(&n_valid, mine);
  __syncthreads();
  int32_t* crow = counts + c * 2 * BUCKETS;
  for (int i = threadIdx.x; i < 2 * BUCKETS; i += THREADS)
    if (bins[i]) atomicAdd(crow + i, bins[i]);
  if (shift == 24 && threadIdx.x == 0 && n_valid) atomicAdd(m + c, n_valid);
}

__global__ void center_select_kernel(const int32_t* __restrict__ counts,
                                     const int32_t* __restrict__ m, int64_t V,
                                     int shift, int32_t* state,
                                     int32_t* centers) {
  int64_t c = blockIdx.x;
  int r = threadIdx.x;  // 0: the low middle rank, 1: the high one
  if (r < 2) {
    int32_t* st = state + c * 4 + 2 * r;       // {prefix, remaining rank}
    uint32_t prefix;
    int64_t rank;
    if (shift == 24) {
      int64_t mm = m[c];
      rank = r == 0 ? (mm > 0 ? (mm - 1) / 2 : 0)
                    : (mm / 2 < V - 1 ? mm / 2 : V - 1);
      prefix = 0;
    } else {
      prefix = static_cast<uint32_t>(st[0]);
      rank = st[1];
    }
    const int32_t* cnt = counts + c * 2 * BUCKETS + r * BUCKETS;
    int64_t below = 0;
    uint32_t b = 0;
    for (; b < BUCKETS; ++b) {
      int64_t next = below + cnt[b];
      if (next > rank) break;
      below = next;
    }
    st[0] = static_cast<int32_t>(prefix | (b << shift));
    st[1] = static_cast<int32_t>(rank - below);
  }
  __syncthreads();
  if (shift == 0 && r == 0) {
    const int32_t* st = state + c * 4;
    int32_t lo = static_cast<int32_t>(static_cast<uint32_t>(st[0]) ^ KEY_BIAS);
    int32_t hi = static_cast<int32_t>(static_cast<uint32_t>(st[2]) ^ KEY_BIAS);
    int32_t d = static_cast<int32_t>(static_cast<uint32_t>(hi) -
                                     static_cast<uint32_t>(lo));
    int64_t d64 = d;
    int64_t half = (d64 - (d64 & 1)) / 2;      // floor(d / 2)
    int32_t ctr = static_cast<int32_t>(static_cast<uint32_t>(lo) +
                                       static_cast<uint32_t>(half));
    centers[c] = m[c] > 0 ? ctr : 0;
  }
}

}  // namespace

// q (C, V) int32, valid (C, V) bytes -> centers (C,) int32. counts
// (C, 2, 256), state (C, 4) and m (C,) are int32 scratch.
extern "C" int ceaz_dq_center(const void* q, const void* valid, int64_t C,
                              int64_t V, void* counts, void* state, void* m,
                              void* centers, void* stream) {
  if (C <= 0 || V <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(m, 0, C * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(state, 0, C * 4 * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((V + SEG - 1) / SEG),
            static_cast<unsigned>(C));
  for (int shift = 24; shift >= 0; shift -= 8) {
    err = cudaMemsetAsync(counts, 0, C * 2 * BUCKETS * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    center_hist_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const int32_t*>(q), static_cast<const uint8_t*>(valid), V,
        shift, static_cast<const int32_t*>(state),
        static_cast<int32_t*>(counts), static_cast<int32_t*>(m));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    center_select_kernel<<<static_cast<unsigned>(C), 32, 0, s>>>(
        static_cast<const int32_t*>(counts), static_cast<const int32_t*>(m), V,
        shift, static_cast<int32_t*>(state), static_cast<int32_t*>(centers));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
