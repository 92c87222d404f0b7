// Single-pass bank encode, quantize half: dual-quantization + per-chunk
// 1024-bin histogram, and the bank select that follows it.
//
// Replaces, from src/repro/kernels/megakernel/kernel.py:
//   * lorenzo_tiles (:254; pallas_call :261) and the quantize/histogram
//     half of ceaz_chunk_fused (:138; pallas_call :149) — Lorenzo mode;
//   * value_quant_tiles (:290; pallas_call :293) — quantize-only mode;
//   * value_finalize_tiles (:306; pallas_call :310) and the value-direct
//     postquantize/histogram of ceaz_chunk_fused — finalize mode;
//   * the bank select of ceaz_chunk_fused (:111-113; the tiled regime
//     runs it as jnp, megakernel/ref.py::select_bank) — bank_select.
// The gather-pack of the selected rows is PR 11's hufenc.cu.
//
// quant_kernel<MODE>, grid (segments of SEG values, chunk rows):
//   LORENZO   q = prequant(x[i]), pred = prequant(x[i-1]) with x[-1] the
//             row's raw halo prev[c] (the value before the chunk in the
//             stream, 0 for its head). A segment's first value reads the
//             previous segment's last RAW value and re-quantizes it, so
//             blocks never exchange q — prequantization is elementwise,
//             which makes the rows equal to one global 1-D Lorenzo pass.
//   VALUE_QUANT     q = prequant(x[i]) only (no mask: the centre of the
//             row is selected over its valid entries afterwards).
//   VALUE_FINALIZE  pred = centers[c] for the row's stored q.
// Outputs as the reference's _postquant (megakernel/kernel.py:67-75):
// past the valid prefix q, codes, delta are 0 and outl false. Valid
// entries are counted into the row's histogram in shared memory
// (warp-aggregated atomics), flushed with atomicAdd into the zeroed
// (C, 1024) global histograms. The TPU accumulates the histogram across
// its sequential segment grid (:224-229, :246-251); CUDA blocks run in
// no order, and integer sums do not depend on it.
//
// bank_select_kernel, one block per row: cost_k = sum_s hist[s] *
// lengths[k, s] in int32 (at most 16 x 2^23 < 2^31 for a default
// chunk; sums wrap like the reference's int32 einsum beyond that), the
// first-occurrence argmin (jnp.argmin, replayed by the host
// BankCoder.step), its total, and the selected book's lengths/codewords
// gathered into (C, 1024) rows for the pack.
//
// Bound on the H100: bytes. The Lorenzo kernel reads 4 B of x and 1 B
// of valid and writes 13 B per value (q, codes, delta, outl) for ~25
// f32 operations; the select reads 4 KB of histogram and K x 8 KB of
// bank tables per row (L2-resident across rows).
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

using ceaz::NUM_SYMBOLS;

constexpr int THREADS = 256;
constexpr int64_t SEG = 4096;     // values per block
constexpr uint32_t NO_BIN = 0xFFFFFFFFu;

enum Mode { LORENZO = 0, VALUE_QUANT = 1, VALUE_FINALIZE = 2 };

// One shared-memory atomicAdd per distinct bin of the warp (collective:
// the whole warp calls it; `bin` is NO_BIN where a lane does not count).
__device__ __forceinline__ void warp_count(int32_t* bins, uint32_t bin) {
  unsigned peers = __match_any_sync(0xffffffffu, bin);
  int leader = __ffs(peers) - 1;
  if (bin != NO_BIN && (threadIdx.x & 31) == leader)
    atomicAdd(bins + bin, __popc(peers));
}

template <int MODE>
__global__ void quant_kernel(const float* __restrict__ work,
                             const float* __restrict__ prev,
                             const uint8_t* __restrict__ valid,
                             const float* __restrict__ ebs,
                             const int32_t* __restrict__ q_in,
                             const int32_t* __restrict__ centers, int64_t cv,
                             int32_t* q_out, int32_t* codes, uint8_t* outl,
                             int32_t* delta, int32_t* hists) {
  __shared__ int32_t bins[NUM_SYMBOLS];
  if (MODE != VALUE_QUANT) {
    for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS) bins[s] = 0;
    __syncthreads();
  }
  int64_t c = blockIdx.y;
  int64_t row = c * cv;
  int64_t s0 = static_cast<int64_t>(blockIdx.x) * SEG;
  int64_t s1 = s0 + SEG < cv ? s0 + SEG : cv;
  float eb = 0.0f, two_eb = 0.0f;
  if (MODE != VALUE_FINALIZE) {
    eb = ebs[c];
    two_eb = ceaz::two_eb_of(eb);
  }
  // every lane runs the same number of iterations (warp_count is a
  // collective); lanes past the segment count nothing
  for (int64_t base = s0; base < s1; base += THREADS) {
    int64_t i = base + threadIdx.x;
    uint32_t bin = NO_BIN;
    if (i < s1) {
      int64_t at = row + i;
      if (MODE == VALUE_QUANT) {
        q_out[at] = ceaz::prequant(work[at], eb, two_eb);
      } else {
        int32_t q, pred;
        if (MODE == LORENZO) {
          q = ceaz::prequant(work[at], eb, two_eb);
          float before = i > 0 ? work[at - 1] : prev[c];
          pred = ceaz::prequant(before, eb, two_eb);
        } else {
          q = q_in[at];
          pred = centers[c];
        }
        bool v = valid[at] != 0;
        ceaz::Post p = ceaz::postquant(q, pred);
        q_out[at] = v ? q : 0;
        codes[at] = v ? p.code : 0;
        outl[at] = (v && p.outlier) ? 1 : 0;
        delta[at] = v ? p.delta : 0;
        if (v) bin = static_cast<uint32_t>(p.code);
      }
    }
    if (MODE != VALUE_QUANT) warp_count(bins, bin);
  }
  if (MODE != VALUE_QUANT) {
    __syncthreads();
    int32_t* hrow = hists + c * NUM_SYMBOLS;
    for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS)
      if (bins[s]) atomicAdd(hrow + s, bins[s]);
  }
}

// Block-wide sum of one uint32 per thread (wrapping), valid in thread 0.
__device__ uint32_t block_sum(uint32_t v, uint32_t* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  uint32_t total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

__global__ void bank_select_kernel(const int32_t* __restrict__ hists,
                                   const int32_t* __restrict__ bank_lengths,
                                   const int32_t* __restrict__ bank_cwords,
                                   int64_t K, int32_t* sel, int32_t* totals,
                                   int32_t* ln_sel, int32_t* cw_sel) {
  __shared__ uint32_t h[NUM_SYMBOLS];
  __shared__ uint32_t scratch[THREADS / 32];
  __shared__ int32_t best_k;
  int64_t c = blockIdx.x;
  for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS)
    h[s] = static_cast<uint32_t>(hists[c * NUM_SYMBOLS + s]);
  __syncthreads();
  int32_t best = 0;
  int32_t arg = 0;
  for (int64_t k = 0; k < K; ++k) {
    const int32_t* ln = bank_lengths + k * NUM_SYMBOLS;
    uint32_t part = 0;
    for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS)
      part += h[s] * static_cast<uint32_t>(ln[s]);
    int32_t cost = static_cast<int32_t>(block_sum(part, scratch));
    if (threadIdx.x == 0 && (k == 0 || cost < best)) {  // first minimum wins
      best = cost;
      arg = static_cast<int32_t>(k);
    }
  }
  if (threadIdx.x == 0) {
    best_k = arg;
    sel[c] = arg;
    totals[c] = best;
  }
  __syncthreads();
  const int32_t* ln = bank_lengths + static_cast<int64_t>(best_k) * NUM_SYMBOLS;
  const int32_t* cw = bank_cwords + static_cast<int64_t>(best_k) * NUM_SYMBOLS;
  for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS) {
    ln_sel[c * NUM_SYMBOLS + s] = ln[s];
    cw_sel[c * NUM_SYMBOLS + s] = cw[s];
  }
}

inline dim3 quant_grid(int64_t C, int64_t cv) {
  return dim3(static_cast<unsigned>((cv + SEG - 1) / SEG),
              static_cast<unsigned>(C));
}

}  // namespace

// Lorenzo mode: work (C, cv) f32, prev (C,) f32 raw halo, valid (C, cv)
// bytes, ebs (C,) f32 -> q, codes, delta (C, cv) i32, outl (C, cv) bytes;
// hists (C, 1024) i32 must be zeroed by the caller.
extern "C" int ceaz_bank_lorenzo(const void* work, const void* prev,
                                 const void* valid, const void* ebs, int64_t C,
                                 int64_t cv, void* q, void* codes, void* outl,
                                 void* delta, void* hists, void* stream) {
  if (C > 0 && cv > 0) {
    quant_kernel<LORENZO><<<quant_grid(C, cv), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(work), static_cast<const float*>(prev),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(ebs),
        nullptr, nullptr, cv, static_cast<int32_t*>(q),
        static_cast<int32_t*>(codes), static_cast<uint8_t*>(outl),
        static_cast<int32_t*>(delta), static_cast<int32_t*>(hists));
  }
  return static_cast<int>(cudaGetLastError());
}

// Quantize-only mode: work (C, cv) f32, ebs (C,) f32 -> q (C, cv) i32.
extern "C" int ceaz_bank_value_quant(const void* work, const void* ebs,
                                     int64_t C, int64_t cv, void* q,
                                     void* stream) {
  if (C > 0 && cv > 0) {
    quant_kernel<VALUE_QUANT><<<quant_grid(C, cv), THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(work), nullptr, nullptr,
        static_cast<const float*>(ebs), nullptr, nullptr, cv,
        static_cast<int32_t*>(q), nullptr, nullptr, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// Finalize mode: q_in (C, cv) i32, valid (C, cv) bytes, centers (C,) i32
// -> q (masked), codes, delta (C, cv) i32, outl (C, cv) bytes; hists
// (C, 1024) i32 must be zeroed by the caller.
extern "C" int ceaz_bank_value_finalize(const void* q_in, const void* valid,
                                        const void* centers, int64_t C,
                                        int64_t cv, void* q, void* codes,
                                        void* outl, void* delta, void* hists,
                                        void* stream) {
  if (C > 0 && cv > 0) {
    quant_kernel<VALUE_FINALIZE><<<quant_grid(C, cv), THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        nullptr, nullptr, static_cast<const uint8_t*>(valid), nullptr,
        static_cast<const int32_t*>(q_in),
        static_cast<const int32_t*>(centers), cv, static_cast<int32_t*>(q),
        static_cast<int32_t*>(codes), static_cast<uint8_t*>(outl),
        static_cast<int32_t*>(delta), static_cast<int32_t*>(hists));
  }
  return static_cast<int>(cudaGetLastError());
}

// hists (C, 1024) i32, bank tables (K, 1024) i32 -> sel, totals (C,) i32
// and the selected rows ln_sel, cw_sel (C, 1024) i32.
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
