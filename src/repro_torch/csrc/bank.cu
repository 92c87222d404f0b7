// Single-pass bank encode, quantize-and-select half: dual-quantization,
// the per-chunk 1024-bin histogram, and the bank select, in one launch.
//
// Replaces, from src/repro/kernels/megakernel/kernel.py:
//   * lorenzo_tiles (:254; pallas_call :261) and the quantize, histogram
//     and select of ceaz_chunk_fused (:138; pallas_call :149; the select
//     :111-113) — Lorenzo mode;
//   * value_quant_tiles (:290; pallas_call :293) — quantize-only mode;
//   * value_finalize_tiles (:306; pallas_call :310) and the value-direct
//     postquantize, histogram and select of ceaz_chunk_fused — finalize
//     mode;
//   * the bank select on its own (the tiled regime runs it as jnp,
//     megakernel/ref.py::select_bank) — bank_select.
// The gather-pack of the selected rows is hufenc.cu's kernel.
//
// quant_kernel<MODE>, a CTA a 4096-value row tile numbered flat
// (row_tiles.cuh; a resident grid taking several tiles a CTA measured
// slower), a row of no values one empty tile. Each thread takes 4 groups
// of 4 consecutive values, a warp's groups contiguous:
//   LORENZO   q = prequant(x[i]), pred = prequant(x[i-1]). The thread's
//             own registers hold x[i-1] past a group's first value; for
//             the first, lane l-1 passes its group's last q by
//             __shfl_up_sync, and a warp's lane 0 loads the raw x[i-1]
//             (or the row's raw halo prev[c] at the row's head: the value
//             before the chunk in the stream, 0 for its head) and
//             re-quantizes it.
//             Prequantization is elementwise, so every q equals one
//             global 1-D Lorenzo pass's.
//   VALUE_QUANT     q = prequant(x[i]) only (no mask: the centre of the
//             row is selected over its valid entries afterwards).
//   VALUE_FINALIZE  pred = centers[c] for the row's stored q.
// A group loads 16 B of x (or q) and 4 B of valid and stores 16 B of q,
// codes and delta and 4 B of outl (where cv % 4 == 0 and the pointers
// allow; scalar otherwise); a thread issues all its loads first.
// Outputs as the reference's _postquant (megakernel/kernel.py:67-75):
// past the valid prefix q, codes, delta are 0 and outl false. Valid codes
// are counted into the CTA's shared histogram (plain shared atomics, a
// group's runs of equal codes one atomic; one histogram measured faster
// than two or eight per-warp ones merged at the end), added to the row's
// global histogram (only the nonzero bins) when the CTA's tile ends. The
// TPU accumulates the histogram across its sequential segment grid
// (:224-229, :246-251); CUDA blocks run in no order, and integer sums do
// not depend on it.
//
// The select (when the op passes the bank): the CTA that publishes a
// row's last tile (a per-row ticket) reads the finished histogram from
// the L2 and computes cost_k = sum_s hist[s] * lengths[k, s] in int32
// (at most 16 x 2^23 < 2^31 for a default chunk; sums wrap like the
// reference's int32 einsum beyond that), a warp a book, then the
// first-occurrence argmin (jnp.argmin, replayed by the host
// BankCoder.step), its total, and the selected book's lengths/codewords
// gathered into (C, 1024) rows for the pack. It reads 4 KB of histogram
// and K x 4 KB of lengths (L2-resident across rows) and writes 8 KB a
// row, in one CTA a row while the others quantize. bank_select_kernel
// runs the same select alone, a CTA a row.
//
// The pack stays a separate launch: the select needs the whole row's
// histogram before the first code of the row can be packed, and a row's
// tiles are spread over many CTAs (a CTA waiting on the others would need
// them all resident).
//
// Bound on the H100: bytes. The Lorenzo pass reads 4 B of x and 1 B of
// valid and writes 13 B (q, codes, delta, outl) a value — 18 B — for ~25
// f32 operations (prequant once, twice at a warp's edge).
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "quant.cuh"
#include "row_tiles.cuh"

namespace {

using ceaz::NUM_SYMBOLS;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = 4;                   // groups of 4 values a thread
constexpr int64_t TILE = THREADS * GROUPS * 4;   // values a tile
constexpr unsigned FULL = 0xffffffffu;

enum Mode { LORENZO = 0, VALUE_QUANT = 1, VALUE_FINALIZE = 2 };

struct QuantArgs {
  const float* work;
  const float* prev;
  const uint8_t* valid;
  const float* ebs;
  const int32_t* q_in;
  const int32_t* centers;
  int64_t C, cv, S;
  bool vec;                 // 16-byte loads and stores for whole groups
  int32_t* q_out;
  int32_t* codes;
  uint8_t* outl;
  int32_t* delta;
  int32_t* hists;           // (C, 1024), zeroed
  int32_t* tickets;         // (C,), zeroed; the select's
  const int32_t* bank_lengths;
  const int32_t* bank_cwords;
  int64_t K;                // 0: no select
  int32_t* sel;
  int32_t* totals;
  int32_t* ln_sel;
  int32_t* cw_sel;
};

// The select of row c from its histogram h (shared, 1024 bins): writes
// sel[c], totals[c] and the selected book's rows. costs[WARPS] and
// best[1] are shared.
__device__ void select_row(const int32_t* h, const int32_t* bank_lengths,
                           const int32_t* bank_cwords, int64_t K, int64_t c,
                           int32_t* sel, int32_t* totals, int32_t* ln_sel,
                           int32_t* cw_sel, int32_t* costs, int32_t* best) {
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t low = 0, arg = 0;                  // thread 0's running argmin
  for (int64_t k0 = 0; k0 < K; k0 += WARPS) {
    int64_t k = k0 + warp;
    if (k < K) {
      const int32_t* ln = bank_lengths + k * NUM_SYMBOLS;
      uint32_t part = 0;
      for (int s = lane; s < NUM_SYMBOLS; s += 32)
        part += static_cast<uint32_t>(h[s]) * static_cast<uint32_t>(ln[s]);
      part = __reduce_add_sync(FULL, part);
      if (lane == 0) costs[warp] = static_cast<int32_t>(part);
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 0; w < WARPS && k0 + w < K; ++w)
        if (k0 + w == 0 || costs[w] < low) {   // the first minimum wins
          low = costs[w];
          arg = static_cast<int32_t>(k0 + w);
        }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    best[0] = arg;
    sel[c] = arg;
    totals[c] = low;
  }
  __syncthreads();
  const int32_t* ln = bank_lengths + static_cast<int64_t>(best[0]) * NUM_SYMBOLS;
  const int32_t* cw = bank_cwords + static_cast<int64_t>(best[0]) * NUM_SYMBOLS;
  for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS) {
    ln_sel[c * NUM_SYMBOLS + s] = ln[s];
    cw_sel[c * NUM_SYMBOLS + s] = cw[s];
  }
}

// A group: 4 consecutive values of a row at flat index `at`, n of them in
// the row; 16-byte (valid: 4-byte) accesses for a whole group where the
// launch allows, scalar ones otherwise.
__device__ __forceinline__ void load4(const float* p, int64_t at, int64_t n,
                                      bool vec, float out[4]) {
  if (vec && n >= 4) {
    float4 v = *reinterpret_cast<const float4*>(p + at);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = e < n ? p[at + e] : 0.0f;
  }
}

__device__ __forceinline__ void load4(const int32_t* p, int64_t at,
                                      int64_t n, bool vec, int32_t out[4]) {
  if (vec && n >= 4) {
    int4 v = *reinterpret_cast<const int4*>(p + at);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = e < n ? p[at + e] : 0;
  }
}

__device__ __forceinline__ void store4(int32_t* p, int64_t at, int64_t n,
                                       bool vec, const int32_t v[4]) {
  if (vec && n >= 4) {
    *reinterpret_cast<int4*>(p + at) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) p[at + e] = v[e];
  }
}

// The group's valid flags as a 4-bit mask.
__device__ __forceinline__ uint32_t load_mask4(const uint8_t* valid,
                                               int64_t at, int64_t n,
                                               bool vec) {
  uint32_t mask = 0;
  if (vec && n >= 4) {
    uint32_t w = *reinterpret_cast<const uint32_t*>(valid + at);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((w >> (8 * e)) & 0xffu) mask |= 1u << e;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n && valid[at + e]) mask |= 1u << e;
  }
  return mask;
}

__device__ __forceinline__ void store_flags4(uint8_t* outl, int64_t at,
                                             int64_t n, bool vec,
                                             uint32_t flags) {
  if (vec && n >= 4) {
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) w |= ((flags >> e) & 1u) << (8 * e);
    *reinterpret_cast<uint32_t*>(outl + at) = w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) outl[at + e] = (flags >> e) & 1u;
  }
}

// The quantize of one group (see load4) at flat index `at`, row value
// i0, n values in the row; its valid codes into the CTA's histogram h.
template <int MODE>
__device__ __forceinline__ void quant_group(const QuantArgs& a, int64_t c,
                                            int64_t i0, int64_t at,
                                            const float x[4],
                                            const int32_t qin[4],
                                            uint32_t vmask, float eb,
                                            float two_eb, int32_t* h) {
  int64_t n = a.cv - i0;
  int32_t q[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    q[e] = MODE == VALUE_FINALIZE ? qin[e] : ceaz::prequant(x[e], eb, two_eb);
  if (MODE == VALUE_QUANT) {
    store4(a.q_out, at, n, a.vec, q);
    return;
  }
  int32_t pred0;
  if (MODE == LORENZO) {
    // the value before the group: lane l-1's last, or at a warp's edge
    // the raw value re-quantized
    pred0 = __shfl_up_sync(FULL, q[3], 1);
    if ((threadIdx.x & 31) == 0 && n > 0)
      pred0 = ceaz::prequant(i0 > 0 ? a.work[at - 1] : a.prev[c], eb, two_eb);
  } else {
    pred0 = a.centers[c];
  }
  int32_t code[4], dl[4];
  uint32_t oflags = 0;
#pragma unroll
  for (int e = 3; e >= 0; --e) {            // q[e-1] is read unmasked
    bool v = (vmask >> e) & 1;
    int32_t pred = MODE == LORENZO && e > 0 ? q[e - 1] : pred0;
    ceaz::Post p = ceaz::postquant(q[e], pred);
    code[e] = v ? p.code : 0;
    dl[e] = v ? p.delta : 0;
    if (v && p.outlier) oflags |= 1u << e;
    q[e] = v ? q[e] : 0;
  }
  store4(a.q_out, at, n, a.vec, q);
  store4(a.codes, at, n, a.vec, code);
  store4(a.delta, at, n, a.vec, dl);
  store_flags4(a.outl, at, n, a.vec, oflags);
  // runs of equal valid codes, one atomic each
  int cur = -1, cnt = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!((vmask >> e) & 1)) continue;
    if (code[e] != cur) {
      if (cnt) atomicAdd(h + cur, cnt);
      cur = code[e];
      cnt = 0;
    }
    ++cnt;
  }
  if (cnt) atomicAdd(h + cur, cnt);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 4) quant_kernel(QuantArgs a) {
  constexpr bool HIST = MODE != VALUE_QUANT;
  __shared__ int32_t h[HIST ? NUM_SYMBOLS : 1];
  __shared__ int32_t costs[WARPS];
  __shared__ int32_t best[1];
  __shared__ int flag;
  if (HIST) {
    for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS) h[s] = 0;
    __syncthreads();
  }
  int64_t t = blockIdx.x, c = t / a.S;       // this CTA's tile, of row c
  float eb = 0.0f, two_eb = 0.0f;
  if (MODE != VALUE_FINALIZE) {
    eb = a.ebs[c];
    two_eb = ceaz::two_eb_of(eb);
  }
  // all loads of the tile first: GROUPS groups of 4 values a thread,
  // THREADS groups apart, so a warp's accesses are contiguous
  int64_t tile0 = (t - c * a.S) * TILE;
  float x[GROUPS][4];
  int32_t qin[GROUPS][4];
  uint32_t vmask[GROUPS];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    int64_t i0 = tile0 + 4 * (threadIdx.x + THREADS * j);
    int64_t at = c * a.cv + i0;
    if (MODE == VALUE_FINALIZE)
      load4(a.q_in, at, a.cv - i0, a.vec, qin[j]);
    else
      load4(a.work, at, a.cv - i0, a.vec, x[j]);
    vmask[j] = MODE == VALUE_QUANT
                   ? 0u
                   : load_mask4(a.valid, at, a.cv - i0, a.vec);
  }
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    int64_t i0 = tile0 + 4 * (threadIdx.x + THREADS * j);
    quant_group<MODE>(a, c, i0, c * a.cv + i0, x[j], qin[j], vmask[j], eb,
                      two_eb, h);
  }
  if (!HIST) return;
  // publish the tile's counts; the row's last tile selects
  __syncthreads();
  int32_t* hrow = a.hists + c * NUM_SYMBOLS;
  for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS)
    if (h[s]) atomicAdd(hrow + s, h[s]);
  if (a.K > 0 && ceaz::last_of_row(a.tickets, c, 1, a.S, &flag)) {
    for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS)
      h[s] = __ldcg(hrow + s);
    __syncthreads();
    select_row(h, a.bank_lengths, a.bank_cwords, a.K, c, a.sel, a.totals,
               a.ln_sel, a.cw_sel, costs, best);
  }
}

__global__ void __launch_bounds__(THREADS)
bank_select_kernel(const int32_t* __restrict__ hists,
                   const int32_t* __restrict__ bank_lengths,
                   const int32_t* __restrict__ bank_cwords, int64_t K,
                   int32_t* sel, int32_t* totals, int32_t* ln_sel,
                   int32_t* cw_sel) {
  __shared__ int32_t h[NUM_SYMBOLS];
  __shared__ int32_t costs[WARPS];
  __shared__ int32_t best[1];
  int64_t c = blockIdx.x;
  for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS)
    h[s] = hists[c * NUM_SYMBOLS + s];
  __syncthreads();
  select_row(h, bank_lengths, bank_cwords, K, c, sel, totals, ln_sel, cw_sel,
             costs, best);
}

template <int MODE>
int launch_quant(QuantArgs& a, void* zeroed, int64_t zero_bytes,
                 void* stream) {
  if (a.C <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (zero_bytes > 0) {
    cudaError_t err = cudaMemsetAsync(zeroed, 0, zero_bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // rows of no values: zero histograms, and with the bank still a select
  if (a.cv <= 0 && a.K == 0) return static_cast<int>(cudaGetLastError());
  a.S = a.cv > 0 ? (a.cv + TILE - 1) / TILE : 1;
  // a CTA a tile: measured faster than a resident grid of CTAs taking
  // several tiles each. 2^31 tiles would be 2^43 values.
  if (a.C * a.S > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  quant_kernel<MODE><<<static_cast<unsigned>(a.C * a.S), THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool all_aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p && !ceaz::aligned16(p)) return false;
  return true;
}

// The select's half of the arguments; K = 0 without the bank.
void set_select(QuantArgs& a, int64_t C, void* zeroed,
                const void* bank_lengths, const void* bank_cwords, int64_t K,
                void* sel, void* totals, void* ln_sel, void* cw_sel) {
  a.hists = static_cast<int32_t*>(zeroed);
  a.tickets = a.hists + C * NUM_SYMBOLS;
  a.bank_lengths = static_cast<const int32_t*>(bank_lengths);
  a.bank_cwords = static_cast<const int32_t*>(bank_cwords);
  a.K = K;
  a.sel = static_cast<int32_t*>(sel);
  a.totals = static_cast<int32_t*>(totals);
  a.ln_sel = static_cast<int32_t*>(ln_sel);
  a.cw_sel = static_cast<int32_t*>(cw_sel);
}

}  // namespace

// Lorenzo mode: work (C, cv) f32, prev (C,) f32 raw halo, valid (C, cv)
// bytes, ebs (C,) f32 -> q, codes, delta (C, cv) i32, outl (C, cv) bytes.
// `zeroed` holds hists (C, 1024) i32 then, with the bank (K > 0), the
// tickets (C,) i32; this entry zeroes its first zero_bytes bytes (the
// caller may append words of its own, e.g. the op's zero centres). With
// the bank (K, 1024) i32 tables -> sel, totals (C,) i32 and the selected
// rows ln_sel, cw_sel (C, 1024) i32.
extern "C" int ceaz_bank_lorenzo(const void* work, const void* prev,
                                 const void* valid, const void* ebs, int64_t C,
                                 int64_t cv, void* q, void* codes, void* outl,
                                 void* delta, void* zeroed, int64_t zero_bytes,
                                 const void* bank_lengths,
                                 const void* bank_cwords, int64_t K, void* sel,
                                 void* totals, void* ln_sel, void* cw_sel,
                                 void* stream) {
  QuantArgs a{};
  a.work = static_cast<const float*>(work);
  a.prev = static_cast<const float*>(prev);
  a.valid = static_cast<const uint8_t*>(valid);
  a.ebs = static_cast<const float*>(ebs);
  a.C = C, a.cv = cv;
  a.q_out = static_cast<int32_t*>(q);
  a.codes = static_cast<int32_t*>(codes);
  a.outl = static_cast<uint8_t*>(outl);
  a.delta = static_cast<int32_t*>(delta);
  a.vec = cv % 4 == 0 && all_aligned16({work, valid, q, codes, outl, delta});
  set_select(a, C, zeroed, bank_lengths, bank_cwords, K, sel, totals, ln_sel,
             cw_sel);
  return launch_quant<LORENZO>(a, zeroed, zero_bytes, stream);
}

// Quantize-only mode: work (C, cv) f32, ebs (C,) f32 -> q (C, cv) i32.
extern "C" int ceaz_bank_value_quant(const void* work, const void* ebs,
                                     int64_t C, int64_t cv, void* q,
                                     void* stream) {
  QuantArgs a{};
  a.work = static_cast<const float*>(work);
  a.ebs = static_cast<const float*>(ebs);
  a.C = C, a.cv = cv;
  a.q_out = static_cast<int32_t*>(q);
  a.vec = cv % 4 == 0 && all_aligned16({work, q});
  return launch_quant<VALUE_QUANT>(a, nullptr, 0, stream);
}

// Finalize mode: q_in (C, cv) i32, valid (C, cv) bytes, centers (C,) i32
// -> q (masked), codes, delta (C, cv) i32, outl (C, cv) bytes; `zeroed`,
// the bank and the select's outputs as in ceaz_bank_lorenzo.
extern "C" int ceaz_bank_value_finalize(
    const void* q_in, const void* valid, const void* centers, int64_t C,
    int64_t cv, void* q, void* codes, void* outl, void* delta, void* zeroed,
    int64_t zero_bytes, const void* bank_lengths, const void* bank_cwords,
    int64_t K, void* sel, void* totals, void* ln_sel, void* cw_sel,
    void* stream) {
  QuantArgs a{};
  a.valid = static_cast<const uint8_t*>(valid);
  a.q_in = static_cast<const int32_t*>(q_in);
  a.centers = static_cast<const int32_t*>(centers);
  a.C = C, a.cv = cv;
  a.q_out = static_cast<int32_t*>(q);
  a.codes = static_cast<int32_t*>(codes);
  a.outl = static_cast<uint8_t*>(outl);
  a.delta = static_cast<int32_t*>(delta);
  a.vec = cv % 4 == 0 && all_aligned16({q_in, valid, q, codes, outl, delta});
  set_select(a, C, zeroed, bank_lengths, bank_cwords, K, sel, totals, ln_sel,
             cw_sel);
  return launch_quant<VALUE_FINALIZE>(a, zeroed, zero_bytes, stream);
}

// hists (C, 1024) i32, bank tables (K, 1024) i32 -> sel, totals (C,) i32
// and the selected rows ln_sel, cw_sel (C, 1024) i32; a CTA a row.
extern "C" int ceaz_bank_select(const void* hists, const void* bank_lengths,
                                const void* bank_cwords, int64_t C, int64_t K,
                                void* sel, void* totals, void* ln_sel,
                                void* cw_sel, void* stream) {
  if (C > 0 && K > 0) {
    bank_select_kernel<<<static_cast<unsigned>(C), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(hists),
        static_cast<const int32_t*>(bank_lengths),
        static_cast<const int32_t*>(bank_cwords), K,
        static_cast<int32_t*>(sel), static_cast<int32_t*>(totals),
        static_cast<int32_t*>(ln_sel), static_cast<int32_t*>(cw_sel));
  }
  return static_cast<int>(cudaGetLastError());
}
