// Value-direct chunk centre: the count-aware median of each row's valid
// entries, by a range pass and wide-digit selection.
//
// Replaces the TPU kernel src/repro/kernels/dualquant/kernel.py::dq_center
// (:220; pallas_call :224; per-row core _center_from_q :200 and
// _select_rank :179), which the reference also inlines into
// megakernel/kernel.py::ceaz_chunk_fused for value-direct rows.
//
// Keys are (valid ? q : INT32_MAX) ^ 0x80000000 as uint32, so the order
// of the keys is the order of the int32 values. With m valid entries the
// two middle ranks are lo_i = max(m-1, 0) / 2 and hi_i = min(m / 2, V-1),
// both below m when m >= 1: the selection never reaches an invalid
// entry, so only valid keys are counted. Selection is by rank, so
// duplicated keys give the values a sorted row holds there. The centre is
// lo + floor((hi - lo) / 2) in int32 with wrap, 0 when m is 0 — the
// reference's `lo + (hi - lo) // 2` (C's `/` truncates, so the floor is
// written out).
//
// The TPU kernel walks 8 nibble rounds over one VMEM-resident row per
// program. Here:
//   (a) center_range_kernel reads the row once: its valid count m and the
//       least and greatest valid key (a CTA's sums published with one
//       atomic each). The CTA that publishes a row's last tile (a ticket,
//       row_tiles.cuh) sets the ranks, and finishes a row with m = 0 or
//       one distinct key;
//   (b) center_digit_kernel, up to three times: a histogram of the next
//       digit of (key - min) over the keys still in each rank's bucket,
//       from the top of the row's range: 13 bits while both ranks share a
//       bucket (one histogram over the two halves of the shared counts;
//       always so in the first pass), else 12 bits a rank. A range below
//       2^13 is one pass with buckets one key wide; the full int32 range
//       three. The ticket's CTA takes each rank's bucket with a CTA-wide
//       scan over the counts and writes the next prefix, or the centre.
//
// Reads of the row: 2 where the valid keys span fewer than 2^13 values
// (value-direct q spans ~500 values at rel eb 1e-3 and ~5000 at 1e-4 on
// the smoke run's fields), at most 4 (a row spanning all of int32). The
// range pass loads with an L2 evict-last policy and the digit passes
// with evict-first, so a row that fits the L2 (50 MB) is partly read from
// it again. Launches: a memset of the scratch and four kernels, whatever
// the data; a digit pass skips a finished row (a CTA reads the row's
// state once: every thread reading it would queue on one L2 slice).
//
// Bound on the H100: bytes. The function reads 4 B of q and 1 B of valid
// per value once and writes 4 B a row; the work per value is a few
// integer operations. A thread loads 4 groups of 4 values, a warp's
// groups contiguous (16 B of q and 4 B of valid a group).
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_tiles.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = 4;                      // groups of 4 values
constexpr int PER = 4 * GROUPS;                // values a thread
constexpr int64_t TILE = THREADS * PER;        // values a tile
constexpr int DIGIT = 12;                      // bits a pass, two ranks
constexpr int NB = 1 << DIGIT;                 // buckets a rank
constexpr uint32_t KEY_BIAS = 0x80000000u;
constexpr unsigned FULL = 0xffffffffu;

// The per-row state, in int32 words (zeroed by the entry's one memset).
enum {
  S_M,        // valid entries
  S_NMIN,     // ~(least valid key): atomicMax of ~key from 0
  S_MAX,      // greatest valid key
  S_TICKET,   // tiles published in this pass
  S_DONE,     // 1 once the centre is written
  S_SH,       // bits of (key - min) below the rank prefixes
  S_PLO,      // the ranks' prefixes: (key - min) >> S_SH
  S_PHI,
  S_RLO,      // the ranks left within their prefixes
  S_RHI,
  S_WORDS = 16
};

// The 16 values of this thread in the tile whose first value is row
// value i0 (row values from flat index `row`; V a row): GROUPS groups of
// 4 consecutive values, THREADS groups apart, so a warp's loads are
// contiguous (16 B of q and 4 B of valid a group where the launch allows,
// scalar loads otherwise). `keep`: the L2 keeps the lines for a later
// pass (evict-last), else they go first. Their keys, and a mask of the
// valid ones.
__device__ __forceinline__ uint32_t load_keys(const int32_t* __restrict__ q,
                                              const uint8_t* __restrict__ valid,
                                              int64_t row, int64_t i0,
                                              int64_t V, bool vec, bool keep,
                                              uint32_t key[PER]) {
  uint32_t mask = 0;
  uint64_t policy;
  if (keep)
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
        : "=l"(policy));
  else
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
        : "=l"(policy));
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    int64_t g = i0 + 4 * (threadIdx.x + THREADS * j);
    int64_t n = V - g, at = row + g;
    if (vec && n >= 4) {
      int4 a;
      uint32_t w;
      asm("ld.global.nc.L2::cache_hint.v4.s32 {%0,%1,%2,%3}, [%4], %5;"
          : "=r"(a.x), "=r"(a.y), "=r"(a.z), "=r"(a.w)
          : "l"(q + at), "l"(policy));
      asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
          : "=r"(w)
          : "l"(valid + at), "l"(policy));
      key[4 * j + 0] = static_cast<uint32_t>(a.x) ^ KEY_BIAS;
      key[4 * j + 1] = static_cast<uint32_t>(a.y) ^ KEY_BIAS;
      key[4 * j + 2] = static_cast<uint32_t>(a.z) ^ KEY_BIAS;
      key[4 * j + 3] = static_cast<uint32_t>(a.w) ^ KEY_BIAS;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((w >> (8 * e)) & 0xffu) mask |= 1u << (4 * j + e);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        key[4 * j + e] = 0;
        if (e < n) {
          key[4 * j + e] = static_cast<uint32_t>(q[at + e]) ^ KEY_BIAS;
          if (valid[at + e]) mask |= 1u << (4 * j + e);
        }
      }
    }
  }
  return mask;
}

// Count, min and max of the masked keys over the CTA, in every thread.
__device__ __forceinline__ void block_range(uint32_t* n, uint32_t* mn,
                                            uint32_t* mx, uint32_t* sm) {
  uint32_t a = __reduce_add_sync(FULL, *n);
  uint32_t b = __reduce_min_sync(FULL, *mn);
  uint32_t c = __reduce_max_sync(FULL, *mx);
  int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sm[w] = a;
    sm[WARPS + w] = b;
    sm[2 * WARPS + w] = c;
  }
  __syncthreads();
  a = 0, b = ~0u, c = 0;
  for (int i = 0; i < WARPS; ++i) {
    a += sm[i];
    b = min(b, sm[WARPS + i]);
    c = max(c, sm[2 * WARPS + i]);
  }
  __syncthreads();
  *n = a, *mn = b, *mx = c;
}

// Exclusive prefix sums over the CTA of two values a thread.
__device__ __forceinline__ void block_exscan2(uint32_t* a, uint32_t* b,
                                              uint32_t* sm) {
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t ia = *a, ib = *b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t x = __shfl_up_sync(FULL, ia, o);
    uint32_t y = __shfl_up_sync(FULL, ib, o);
    if (lane >= o) ia += x, ib += y;
  }
  if (lane == 31) sm[w] = ia, sm[WARPS + w] = ib;
  __syncthreads();
  uint32_t pa = 0, pb = 0;
  for (int i = 0; i < w; ++i) pa += sm[i], pb += sm[WARPS + i];
  __syncthreads();
  *a = pa + ia - *a;
  *b = pb + ib - *b;
}

// The digit pass's view of a row: (key - kmin) >> sh must equal a rank's
// prefix for the key to count, and its digit is bits [sl, sh). While both
// ranks share a prefix (always in the first pass) one histogram takes
// both halves of the shared counts, 2 NB buckets: a digit of 13 bits,
// else 12 for each rank.
struct Digit {
  uint32_t kmin, plo, phi;
  int sh, sl;
  bool same;          // both ranks in one bucket: one histogram
  __device__ int nb() const { return 1 << (sh - sl); }
};

__device__ __forceinline__ Digit digit_of(uint32_t kmin, int sh, uint32_t plo,
                                          uint32_t phi) {
  Digit d;
  d.kmin = kmin, d.plo = plo, d.phi = phi, d.sh = sh;
  d.same = plo == phi;
  int width = d.same ? DIGIT + 1 : DIGIT;
  d.sl = sh > width ? sh - width : 0;
  return d;
}

// Zero what a pass of d counts in h (h0 = h, h1 = h + NB).
__device__ __forceinline__ void zero_counts(int32_t* h, const Digit& d) {
  for (int i = threadIdx.x; i < d.nb(); i += THREADS) {
    h[i] = 0;
    if (!d.same) h[NB + i] = 0;
  }
}

// Adds one run of `n` equal digits to a histogram.
__device__ __forceinline__ void add_run(int32_t* h, int d, int n) {
  if (n) atomicAdd(h + d, n);
}

// This thread's masked keys into the shared histograms h0 (low rank) and
// h1 (high rank, unless d.same); runs of equal digits take one atomic.
__device__ __forceinline__ void count_keys(const uint32_t key[PER],
                                           uint32_t mask, const Digit& d,
                                           int32_t* h0, int32_t* h1) {
  uint32_t dmask = (1u << (d.sh - d.sl)) - 1;
  int d0 = 0, n0 = 0, d1 = 0, n1 = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (!((mask >> k) & 1)) continue;
    uint64_t rel = key[k] - d.kmin;
    uint32_t top = static_cast<uint32_t>(rel >> d.sh);
    int dg = static_cast<int>((rel >> d.sl) & dmask);
    if (top == d.plo) {
      if (dg != d0) add_run(h0, d0, n0), d0 = dg, n0 = 0;
      ++n0;
    }
    if (!d.same && top == d.phi) {
      if (dg != d1) add_run(h1, d1, n1), d1 = dg, n1 = 0;
      ++n1;
    }
  }
  add_run(h0, d0, n0);
  add_run(h1, d1, n1);
}

// For each rank r, the bucket b[r] of cnt_r[0, nb) that holds it and the
// count below that bucket: each thread sums its nb / THREADS consecutive
// buckets, a CTA-wide exclusive scan places them, and the one thread
// whose buckets hold the rank walks them. The counts are other CTAs'
// atomics, read from the L2. pick[4] is shared.
__device__ void pick_buckets(const int32_t* c0, const int32_t* c1, int nb,
                             uint32_t rlo, uint32_t rhi, uint32_t* pick,
                             uint32_t* sm) {
  int per = (nb + THREADS - 1) / THREADS;
  int lo = threadIdx.x * per;
  int hi = min(lo + per, nb);
  uint32_t s0 = 0, s1 = 0;
  for (int i = lo; i < hi; ++i) {
    s0 += static_cast<uint32_t>(__ldcg(c0 + i));
    s1 += static_cast<uint32_t>(__ldcg(c1 + i));
  }
  uint32_t e0 = s0, e1 = s1;
  block_exscan2(&e0, &e1, sm);
  const int32_t* cs[2] = {c0, c1};
  uint32_t ex[2] = {e0, e1}, sum[2] = {s0, s1}, rank[2] = {rlo, rhi};
  for (int r = 0; r < 2; ++r) {
    if (ex[r] > rank[r] || rank[r] - ex[r] >= sum[r]) continue;
    uint32_t acc = ex[r];
    for (int i = lo; i < hi; ++i) {
      uint32_t v = static_cast<uint32_t>(__ldcg(cs[r] + i));
      if (acc + v > rank[r]) {
        pick[r] = i;
        pick[2 + r] = acc;
        break;
      }
      acc += v;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int32_t centre_of(uint32_t lo_key,
                                             uint32_t hi_key) {
  int32_t lo = static_cast<int32_t>(lo_key ^ KEY_BIAS);
  int32_t hi = static_cast<int32_t>(hi_key ^ KEY_BIAS);
  int32_t d = static_cast<int32_t>(static_cast<uint32_t>(hi) -
                                   static_cast<uint32_t>(lo));
  int64_t d64 = d;
  int64_t half = (d64 - (d64 & 1)) / 2;          // floor(d / 2)
  return static_cast<int32_t>(static_cast<uint32_t>(lo) +
                              static_cast<uint32_t>(half));
}

// Bits of a nonzero range: the smallest L with range < 2^L.
__device__ __forceinline__ int range_bits(uint32_t range) {
  return 32 - __clz(range);
}

// (a) m, min and max of each row's valid keys; the
// ticket's CTA sets the ranks or finishes the row.
__global__ void __launch_bounds__(THREADS)
center_range_kernel(const int32_t* __restrict__ q,
                    const uint8_t* __restrict__ valid, int64_t C, int64_t V,
                    int64_t S, bool vec, int32_t* state, int32_t* centers) {
  __shared__ uint32_t sm[3 * WARPS];
  __shared__ int flag;
  int64_t t0, t1;
  ceaz::cta_span(C * S, &t0, &t1);
  for (int64_t r0 = t0; r0 < t1;) {          // this CTA's tiles of row c
    int64_t c = r0 / S, r1 = ceaz::run_end(r0, t1, S);
    uint32_t n = 0, mn = ~0u, mx = 0;
    for (int64_t t = r0; t < r1; ++t) {
      uint32_t key[PER];
      uint32_t mask = load_keys(q, valid, c * V, (t - c * S) * TILE, V, vec,
                                true, key);
      n += __popc(mask);
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if ((mask >> k) & 1) mn = min(mn, key[k]), mx = max(mx, key[k]);
    }
    block_range(&n, &mn, &mx, sm);
    int32_t* st = state + c * S_WORDS;
    if (threadIdx.x == 0 && n) {
      atomicAdd(st + S_M, static_cast<int32_t>(n));
      atomicMax(reinterpret_cast<uint32_t*>(st + S_NMIN), ~mn);
      atomicMax(reinterpret_cast<uint32_t*>(st + S_MAX), mx);
    }
    if (ceaz::last_of_row(st + S_TICKET, 0, r1 - r0, S, &flag) &&
        threadIdx.x == 0) {
      uint32_t m = static_cast<uint32_t>(__ldcg(st + S_M));
      uint32_t kmin = ~static_cast<uint32_t>(__ldcg(st + S_NMIN));
      uint32_t kmax = static_cast<uint32_t>(__ldcg(st + S_MAX));
      st[S_TICKET] = 0;
      if (m == 0 || kmin == kmax) {
        centers[c] = m == 0 ? 0 : centre_of(kmin, kmin);
        st[S_DONE] = 1;
      } else {
        st[S_SH] = range_bits(kmax - kmin);
        st[S_RLO] = static_cast<int32_t>((m - 1) / 2);
        st[S_RHI] = static_cast<int32_t>(m / 2);
      }
    }
    r0 = r1;
  }
}

// (b) one digit pass. counts (C, 2, NB) are zero
// where this pass counts (the memset, then each pass's ticket CTA). A
// CTA reads a row's state once (the launches before wrote it; every CTA
// reading one word per thread would queue on one L2 slice) and skips a
// finished row's tiles.
__global__ void __launch_bounds__(THREADS)
center_digit_kernel(const int32_t* __restrict__ q,
                    const uint8_t* __restrict__ valid, int64_t C, int64_t V,
                    int64_t S, bool vec, int32_t* state, int32_t* counts,
                    int32_t* centers) {
  __shared__ int32_t h[2 * NB];
  __shared__ uint32_t sm[2 * WARPS];
  __shared__ uint32_t pick[4];
  __shared__ int32_t row[S_WORDS];
  __shared__ int flag;
  int64_t t0, t1;
  ceaz::cta_span(C * S, &t0, &t1);
  bool zeroed = false;
  for (int64_t r0 = t0; r0 < t1;) {
    int64_t c = r0 / S, r1 = ceaz::run_end(r0, t1, S);
    int32_t* st = state + c * S_WORDS;
    if (threadIdx.x < S_WORDS) row[threadIdx.x] = st[threadIdx.x];
    __syncthreads();
    bool done = row[S_DONE] != 0;
    Digit d = digit_of(~static_cast<uint32_t>(row[S_NMIN]), row[S_SH],
                       row[S_PLO], row[S_PHI]);
    uint32_t rlo = row[S_RLO], rhi = row[S_RHI];
    __syncthreads();                  // row is read before the next run's
    if (done) {
      r0 = r1;
      continue;
    }
    if (!zeroed) {
      for (int i = threadIdx.x; i < 2 * NB; i += THREADS) h[i] = 0;
      zeroed = true;
      __syncthreads();
    }
    for (int64_t t = r0; t < r1; ++t) {
      uint32_t key[PER];
      uint32_t mask = load_keys(q, valid, c * V, (t - c * S) * TILE, V, vec,
                                false, key);
      count_keys(key, mask, d, h, h + NB);
    }
    int nb = d.nb();
    int32_t* crow = counts + c * 2 * NB;
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += THREADS) {
      if (h[i]) atomicAdd(crow + i, h[i]);
      if (!d.same && h[NB + i]) atomicAdd(crow + NB + i, h[NB + i]);
    }
    zero_counts(h, d);
    if (ceaz::last_of_row(st + S_TICKET, 0, r1 - r0, S, &flag)) {
      pick_buckets(crow, d.same ? crow : crow + NB, nb, rlo, rhi, pick, sm);
      int w = d.sh - d.sl;
      uint32_t plo = (d.plo << w) | pick[0];
      uint32_t phi = (d.phi << w) | pick[1];
      if (threadIdx.x == 0) {
        st[S_TICKET] = 0;
        if (d.sl == 0) {
          centers[c] = centre_of(d.kmin + plo, d.kmin + phi);
          st[S_DONE] = 1;
        } else {
          st[S_SH] = d.sl;
          st[S_PLO] = static_cast<int32_t>(plo);
          st[S_PHI] = static_cast<int32_t>(phi);
          st[S_RLO] = static_cast<int32_t>(rlo - pick[2]);
          st[S_RHI] = static_cast<int32_t>(rhi - pick[3]);
        }
      }
      if (d.sl != 0) zero_counts(crow, d);
    }
    __syncthreads();
    r0 = r1;
  }
}

int64_t g_fit_range = 0, g_fit_digit = 0;

}  // namespace

// Bytes of dq_center's scratch for C rows of V values: the per-row state
// and the two (NB,) counts.
extern "C" int64_t ceaz_dq_center_scratch_bytes(int64_t C, int64_t V) {
  return V <= 0 ? 0 : C * (S_WORDS + 2 * NB) * 4;
}

// q (C, V) int32, valid (C, V) bytes -> centers (C,) int32 (every row
// written). scratch: ceaz_dq_center_scratch_bytes(C, V) bytes, zeroed
// here by one memset.
extern "C" int ceaz_dq_center(const void* q, const void* valid, int64_t C,
                              int64_t V, void* scratch, void* centers,
                              void* stream) {
  if (C <= 0 || V <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* qp = static_cast<const int32_t*>(q);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  int32_t* cp = static_cast<int32_t*>(centers);
  bool vec = V % 4 == 0 && ceaz::aligned16(q) && ceaz::aligned16(valid);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, ceaz_dq_center_scratch_bytes(C, V), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int32_t* state = static_cast<int32_t*>(scratch);
  int32_t* counts = state + C * S_WORDS;
  int64_t S = (V + TILE - 1) / TILE;
  int64_t g = ceaz::resident_ctas(
      reinterpret_cast<const void*>(center_range_kernel), THREADS, C * S,
      &g_fit_range);
  center_range_kernel<<<static_cast<unsigned>(g), THREADS, 0, s>>>(
      qp, vp, C, V, S, vec, state, cp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  g = ceaz::resident_ctas(reinterpret_cast<const void*>(center_digit_kernel),
                          THREADS, C * S, &g_fit_digit);
  for (int pass = 0; pass < 3; ++pass) {      // 32 bits in 3 digits of >= 12
    center_digit_kernel<<<static_cast<unsigned>(g), THREADS, 0, s>>>(
        qp, vp, C, V, S, vec, state, counts, cp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
