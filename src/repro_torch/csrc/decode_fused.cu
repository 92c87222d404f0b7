// Decode megakernel: table walk + rank-gather outlier patch + inverse
// dual-quant for chunk rows of at most 2^17 values, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/megakernel/decode_kernel.py::
// ceaz_chunk_dec_fused (:146), whose contract is ref.patch_and_inverse
// (src/repro/kernels/megakernel/ref.py:181-185): code 0 is the escape and
// the r-th escape of a row takes its r-th stored delta (r clamped into
// [0, Ko-1]), every other valid code gives code - 512; Lorenzo rows
// (islor) take the inclusive prefix of the deltas, carried from row to
// row through a segment (which restarts where seg0[c] == c; a segment's
// rows are contiguous and ascending), value rows delta + base; zero past
// a row's count. The TPU carries the segment sum through a revisited
// (1, 1) block on its sequential grid. Here CTAs run in no order, so the
// carry is a decoupled look-back (Merrill & Garland, 2016; as
// hufenc.cu's gather_pack) over (row, block) tiles in row order.
//
// Design. A CTA per SM takes tickets in turn (so a tile only waits on
// tiles already taken), each naming a row and up to 16 of its blocks; it
// holds the row's decode table in shared memory (kept while the next
// tile has the same codebook) and each warp decodes one block
// (warp_walk.cuh: the fast path into a shared staging row, or walk_lane
// into the output row when the exact rule rejects the block). Then the
// warp, with no serial thread and no second kernel:
//   1. sums its block's codes and counts its escapes (during the fast
//      path's write pass);
//   2. looks back over the row's earlier blocks for its first escape
//      rank Z (64-bit status words: a 2-bit flag and a 32-bit value);
//   3. adds the escapes' deltas, which take the consecutive ranks
//      [Z, Z + z) (one coalesced range sum), for the block's delta sum;
//   4. looks back over the segment's earlier tiles (resetting at
//      seg0[c]) for the block's exclusive prefix D, carry included;
//   5. writes q once, coalesced: eight codes a lane, the escapes' ranks
//      from ballots of the lanes' escape counts, the prefix from one warp
//      scan of the lanes' sums.
// Every prefix sum and carry runs in uint32 and is reinterpreted: signed
// overflow is undefined in C++, and the reference relies on int32 wrap.
//
// Bound on the H100: bytes (4 B a value out, the words and the decode
// tables in). Per block: the walk's passes (hufdec.cu), then the patch
// pass at 256 values a step; a table load for every row's codebook.
#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"
#include "warp_walk.cuh"

namespace {

constexpr uint32_t RADIUS = 512;
constexpr unsigned long long ST_AGG = 1ull << 62;   // aggregate published
constexpr unsigned long long ST_PRE = 2ull << 62;   // inclusive prefix
constexpr unsigned long long ST_VAL = 0xffffffffull;

__device__ __forceinline__ void publish(unsigned long long* st,
                                        unsigned long long v) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(st) = v;
}

// By the warp: publishes tile t's aggregate, looks back over tiles
// [lo, t) and publishes t's inclusive prefix; -> the exclusive prefix
// (mod 2^32). Tiles before lo count as a prefix of 0.
__device__ uint32_t lookback(unsigned long long* st, int64_t t, int64_t lo,
                             uint32_t agg) {
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    publish(st + t, (t <= lo ? ST_PRE : ST_AGG)
                        | static_cast<unsigned long long>(agg));
  uint32_t excl = 0;
  if (t > lo) {
    for (int64_t j = t - 1;; j -= 32) {
      const int64_t idx = j - lane;
      unsigned long long s = ST_PRE;
      if (idx >= lo) {
        do {
          s = *reinterpret_cast<volatile unsigned long long*>(st + idx);
        } while ((s >> 62) == 0);
      }
      const unsigned pre = __ballot_sync(ceaz::WW_FULL, (s >> 62) == 2);
      const int stop = pre ? __ffs(pre) - 1 : 31;
      excl += ceaz::ww_sum(lane <= stop ? static_cast<uint32_t>(s & ST_VAL)
                                        : 0u);
      if (pre) break;
    }
    if (lane == 0)
      publish(st + t, ST_PRE | static_cast<unsigned long long>(excl + agg));
  }
  return excl;
}

// Step 5 by the warp: q of the block's bs positions into ob, from the
// staged codes (stage) or, after walk_lane, the codes in ob itself.
// rank: the block's first escape rank; run: its exclusive prefix.
__device__ void patch_block(const uint16_t* stage, int32_t cnt, int64_t bs,
                            const int32_t* __restrict__ od, int64_t Ko,
                            uint32_t rank, bool lor, uint32_t run,
                            uint32_t base, int32_t* ob) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  for (int64_t i00 = 0; i00 < bs; i00 += 256) {
    const int64_t i0 = i00 + lane * 8;
    int32_t code[8];
    if (stage != nullptr && i0 < bs) {
      ceaz::ww_stage8(stage, i0, code);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) code[k] = i0 + k < cnt ? ob[i0 + k] : 0;
    }
    unsigned em = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i0 + k < cnt && code[k] == 0) em |= 1u << k;
    const int ne = __popc(em);
    uint32_t pre = 0, tot = 0;
#pragma unroll
    for (int bit = 0; bit < 4; ++bit) {
      const unsigned m = __ballot_sync(ceaz::WW_FULL, (ne >> bit) & 1);
      pre += static_cast<uint32_t>(__popc(m & lt)) << bit;
      tot += static_cast<uint32_t>(__popc(m)) << bit;
    }
    uint32_t r = rank + pre;
    uint32_t loc = 0;
    uint32_t q[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool valid = i0 + k < cnt;
      uint32_t d;
      if ((em >> k) & 1u) {
        const int64_t rr = static_cast<int64_t>(r) < Ko ? r : Ko - 1;
        d = static_cast<uint32_t>(od[rr]);
        ++r;
      } else {
        d = valid ? static_cast<uint32_t>(code[k]) - RADIUS : 0u;
      }
      loc += d;
      q[k] = valid ? (lor ? loc : d + base) : 0u;
    }
    uint32_t x = loc;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(ceaz::WW_FULL, x, o);
      if (lane >= o) x += y;
    }
    const uint32_t lane_run = run + x - loc;
    if (lor) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (i0 + k < cnt) q[k] += lane_run;
    }
    if (i0 < bs) ceaz::ww_put8(ob, i0, bs, reinterpret_cast<int32_t*>(q));
    rank += tot;
    run += __shfl_sync(ceaz::WW_FULL, x, 31);
  }
}

__global__ void __launch_bounds__(ceaz::WW_MAX_WARPS * 32, 1)
ceaz_dec_fused_kernel(const uint32_t* __restrict__ words, int64_t W,
                      const int32_t* __restrict__ nbits,
                      const int32_t* __restrict__ counts,
                      const int32_t* __restrict__ table32,
                      const uint16_t* __restrict__ table16,
                      const int32_t* __restrict__ cb_idx,
                      const int32_t* __restrict__ odelta, int64_t Ko,
                      const int32_t* __restrict__ base,
                      const int32_t* __restrict__ seg0,
                      const int32_t* __restrict__ islor, int64_t NB,
                      int64_t bs, int64_t groups, int64_t tiles, int64_t area,
                      int32_t* out, unsigned long long* zst,
                      unsigned long long* dst, int32_t* ticket,
                      int32_t* stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t part[ceaz::WW_MAX_WARPS];
  __shared__ int s_stats[ceaz::WW_STATS];
  __shared__ int64_t s_tile;
  uint16_t* tbl = reinterpret_cast<uint16_t*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < ceaz::WW_STATS) s_stats[threadIdx.x] = 0;
  uint16_t* stage =
      area ? reinterpret_cast<uint16_t*>(smem + ceaz::WW_TABLE_BYTES
                                         + warp * area)
           : nullptr;
  int64_t loaded = -1;                 // the codebook in tbl
  for (int64_t tile;
       (tile = ceaz::ww_next_tile(ticket, tiles, &s_tile)) >= 0;) {
    const int64_t c = tile / groups;
    const int64_t b0 = (tile % groups) * (blockDim.x >> 5);
    const int64_t b = b0 + warp;
    const int64_t cb = cb_idx[c];
    if (cb != loaded) {
      ceaz::ww_load_table(tbl, table16 + cb * ceaz::TBL);
      loaded = cb;
    }
    const int32_t* nb = nbits + c * NB;
    const uint32_t pbase = ceaz::ww_row_prefix(nb, b0, part);
    const uint32_t* row = words + c * W;
    int32_t rel = 0, cnt = 0;
    bool adm = false;
    if (b < NB) {
      uint32_t own = 0;
      for (int k = lane; k < warp; k += 32)
        own += static_cast<uint32_t>(nb[b0 + k]);
      rel = static_cast<int32_t>(pbase + ceaz::ww_sum(own));
      const int64_t cnt64 = static_cast<int64_t>(counts[c]) - b * bs;
      cnt = static_cast<int32_t>(cnt64 < 0 ? 0 : (cnt64 > bs ? bs : cnt64));
      adm = ceaz::ww_begin(row, W, 0, W, rel, nb[b], cnt, bs, stage);
    }
    ceaz::ww_cp_wait();                // the table and the payloads
    __syncthreads();
    if (b < NB) {
      int32_t* ob = out + (c * NB + b) * bs;
      uint32_t ssum = 0;
      int32_t nz = 0;
      // 0: no valid position; 1: fast path (codes staged); 2: walk_lane
      // (codes in ob)
      int mode = 0;
      if (cnt > 0) {
        mode = ceaz::ww_block(row, W, 0, W, rel, nb[b], cnt, bs, adm, tbl,
                              table32 + cb * ceaz::TBL, stage, ob, &ssum, &nz,
                              s_stats) ? 1 : 2;
        if (mode == 2) {
          uint32_t s = 0, z = 0;
          for (int64_t i = lane; i < cnt; i += 32) {
            const int32_t code = ob[i];
            s += static_cast<uint32_t>(code);
            z += code == 0;
          }
          ssum = ceaz::ww_sum(s);
          nz = static_cast<int32_t>(ceaz::ww_sum(z));
        }
      }
      const int64_t t = c * NB + b;
      const uint32_t Z = lookback(zst, t, c * NB, static_cast<uint32_t>(nz));
      const int32_t* od = odelta + c * Ko;
      uint32_t osum = 0;
      for (int64_t r = static_cast<int64_t>(Z) + lane;
           r < static_cast<int64_t>(Z) + nz; r += 32)
        osum += static_cast<uint32_t>(od[r < Ko ? r : Ko - 1]);
      const uint32_t d = ssum - RADIUS * static_cast<uint32_t>(cnt - nz)
                         + ceaz::ww_sum(osum);
      int64_t s0 = seg0[c];
      s0 = s0 < 0 ? 0 : (s0 > c ? c : s0);
      const uint32_t D = lookback(dst, t, s0 * NB, d);
      if (mode == 0)
        ceaz::ww_zero(bs, ob);
      else
        patch_block(mode == 1 ? stage : nullptr, cnt, bs, od, Ko, Z,
                    islor[c] != 0, D, static_cast<uint32_t>(base[c]), ob);
    }
  }
  ceaz::ww_flush_stats(s_stats, stats);
}

}  // namespace

// Bytes of the look-back scratch for C rows of NB blocks: two 64-bit
// status words a (row, block) tile, then the CTA ticket.
extern "C" int64_t ceaz_dec_fused_scratch_bytes(int64_t C, int64_t NB) {
  return 16 * C * NB + 8;
}

// words (C, W) u32, nbits (C, NB), counts/cb_idx/base/seg0/islor (C,)
// int32; tables as ceaz_pack_tables writes them; odelta (C, Ko) int32,
// Ko >= 1; out (C, NB*bs) int32, fully written; scratch of
// ceaz_dec_fused_scratch_bytes, zeroed here on the stream; stats
// (WW_STATS,) int32, added to. Contract: seg0[c] in [0, c].
extern "C" int ceaz_dec_fused(const void* words, int64_t C, int64_t W,
                              const void* nbits, const void* counts,
                              const void* table32, const void* table16,
                              const void* cb_idx, const void* odelta,
                              int64_t Ko, const void* base, const void* seg0,
                              const void* islor, int64_t NB, int64_t bs,
                              void* out, void* scratch, int64_t bytes,
                              void* stats, void* stream) {
  if (C > 0 && NB > 0) {
    const ceaz::WWConfig cfg = ceaz::ww_config(bs);
    const int64_t groups = (NB + cfg.warps - 1) / cfg.warps;
    if (bs <= 0 || Ko < 1 || W < 2
        || bytes < ceaz_dec_fused_scratch_bytes(C, NB))
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t tiles = C * groups;
    if (tiles >= INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(scratch, 0, bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(ceaz_dec_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cfg.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    auto* zst = static_cast<unsigned long long*>(scratch);
    ceaz_dec_fused_kernel<<<static_cast<unsigned>(ceaz::ww_ctas(tiles)),
                            cfg.warps * 32, cfg.smem, st>>>(
        static_cast<const uint32_t*>(words), W,
        static_cast<const int32_t*>(nbits), static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(table32),
        static_cast<const uint16_t*>(table16),
        static_cast<const int32_t*>(cb_idx),
        static_cast<const int32_t*>(odelta), Ko,
        static_cast<const int32_t*>(base), static_cast<const int32_t*>(seg0),
        static_cast<const int32_t*>(islor), NB, bs, groups, tiles, cfg.area,
        static_cast<int32_t*>(out), zst, zst + C * NB,
        reinterpret_cast<int32_t*>(zst + 2 * C * NB),
        static_cast<int32_t*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}
