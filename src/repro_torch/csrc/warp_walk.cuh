// The warp walk: one warp decodes one (chunk, block) lane of the
// canonical-Huffman table walk, against the chunk's decode table held
// whole in shared memory. Shared by the word-tiled walk (hufdec.cu,
// ceaz_hufdec_tiles) and the decode megakernel (decode_fused.cu).
//
// The table. Every staged entry has a symbol below 1024 and a code
// length of at most 16, so (len << 10) | sym fits 16 bits and a
// codebook's 2^16 windows take 128 KB of shared memory
// (ceaz_pack_tables packs it, and flags any entry outside those ranges
// for the wrapper to raise on). A CTA serves blocks of one chunk row, so
// of one codebook, and loads its table with asynchronous 16-byte copies,
// overlapped with the bit-count prefix and the blocks' payload copies,
// and keeps it while its next tile has the same codebook.
//
// The fast path (Weissenberger and Schmidt, "Massively Parallel Huffman
// Decoding on GPUs", ICPP 2018). The block's bits [S, S + N) are cut into
// 64 segments of ceil(N / 64) bits, two a lane (j and 32 + j), decoded
// step for step together so that each step has two independent lookups
// in flight. A segment is decoded from a start p while its cursor lies
// below its end hi, from the block's words staged in shared memory and
// kept in registers (a step is a funnel shift, the shared-memory lookup
// and an add), and exits at the first codeword boundary >= hi. Segment
// 0 starts at S; segment k > 0 first at its first bit, a guess. Each
// sync round every segment k > 0 takes segment k-1's exit as its new
// start and, if that changed, decodes again, until no start changes.
// Segment 0's start is true, so after round r the starts of segments
// 0..r are true: 64 passes at most, two or three on the phases' streams
// (a guess resynchronises within its segment; a segment of a few bits,
// or a book of near-equal code lengths, may not, and then the true
// starts spread one segment a round). A fixed point is the true one:
// p_0 = S is true, and p_{k+1} = exit(p_k) is then true by induction. A
// segment whose lookup gives length 0 is stuck: it exits at hi, and the
// block is rejected if that happened on the final, true starts. A scan
// of the segments' symbol counts gives each its offset, and a last pass
// writes the symbols into the warp's shared staging row, from which they
// leave in coalesced stores.
//
// The acceptance rule. walk_lane (walk.cuh) writes, for i < cnt =
// min(max(count - b*bs, 0), bs), the symbol at cursor c_i, where c_0 is
// the lane's start and c_{i+1} = c_i + len(peek(clamp(c_i))), clamp into
// [0, cmax], cmax = (win - 2)*32 + 31, words at or past W reading as
// zero; zeros past cnt. The fast path's result is kept only when
//   (a) cnt >= 1, cnt <= N <= 16*cnt, the start (relative to the window)
//       is >= 0 and start + N - 1 <= cmax (checked before decoding);
//   (b) no lookup on the true starts' paths has length 0;
//   (c) the segments' symbols number exactly cnt;
//   (d) the last segment exits exactly at S + N.
// Proof. By (b) the true path c_0 = S < c_1 < ... is strictly
// increasing, and segment k decodes exactly the c_i in [e_{k-1}, hi_k),
// where e_{k-1} is the first c_i >= hi_{k-1} (segment 0 from S): the
// segments together decode the c_i < S + N, in order, each once. By
// (c) those are c_0 .. c_{cnt-1}. Each lies in [S, S + N - 1], so
// relative to the
// window in [0, cmax] by (a): walk_lane's clamp never binds, and both
// peek the same bits with the same zero past W. So the symbols are
// walk_lane's, and positions past cnt are zero in both. ((d) is not
// needed for equality; it makes a corrupted block likelier to be
// rejected.) Any block that fails the rule, and every block when the
// block size leaves no room for a staging row, is walked by the
// unchanged walk_lane inside the same kernel, against the 32-bit
// table: corrupted payloads and garbage bit counts take that path. The
// kernels count both kinds of block and the most sync rounds into a
// small device counter (WW_EXACT, WW_FAST, WW_ROUNDS).
#pragma once
#include <stdint.h>

#include "walk.cuh"

namespace ceaz {

constexpr int WW_SYM_BITS = 10;
constexpr uint32_t WW_SYM_MASK = (1u << WW_SYM_BITS) - 1;
constexpr int WW_TABLE_BYTES = TBL * 2;          // 128 KB of 16-bit entries
constexpr int WW_MAX_WARPS = 16;
constexpr int WW_SMEM_LIMIT = 232448;            // a block's shared memory
constexpr int WW_STATIC_RESERVE = 1024;          // the kernels' static arrays
constexpr unsigned WW_FULL = 0xffffffffu;
enum { WW_EXACT = 0, WW_FAST = 1, WW_ROUNDS = 2, WW_STATS = 3 };

// A warp's shared area: its staging row (ww_out_stride uint16 codes),
// then the words of the block's payload (ww_word_stride uint32; a block
// the fast path admits has N <= 16 bs bits, so at most bs/2 + 7 words
// with the reader's look-ahead). Both 16-byte multiples.
inline __host__ __device__ int64_t ww_out_stride(int64_t bs) {
  return (bs + 7) / 8 * 8;
}
inline __host__ __device__ int64_t ww_word_stride(int64_t bs) {
  return ((bs + 1) / 2 + 8 + 3) / 4 * 4;
}

// Warps a CTA (one block each) and the bytes of a warp's shared area for
// block size bs; area 0 when no area fits beside the table (every block
// then takes walk_lane).
struct WWConfig {
  int warps;
  int64_t area;
  int64_t smem;
};

inline WWConfig ww_config(int64_t bs) {
  const int64_t area = 2 * ww_out_stride(bs) + 4 * ww_word_stride(bs);
  const int64_t budget = WW_SMEM_LIMIT - WW_STATIC_RESERVE - WW_TABLE_BYTES;
  const int64_t fit = bs > 0 ? budget / area : 0;
  WWConfig cfg;
  if (fit < 1) {
    cfg.warps = 1;
    cfg.area = 0;
  } else {
    cfg.warps = static_cast<int>(fit < WW_MAX_WARPS ? fit : WW_MAX_WARPS);
    cfg.area = area;
  }
  cfg.smem = WW_TABLE_BYTES + cfg.warps * cfg.area;
  return cfg;
}

// CTAs of a walk: as many as the SMs (one fits an SM, for its shared
// memory), or fewer tiles. Each takes its tiles (a row's group of up to
// `warps` blocks) one ticket at a time, in order (so a look-back only
// waits on tiles already taken), and keeps its table while the next
// tile has the same codebook.
inline int64_t ww_ctas(int64_t tiles) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess)
    sms = 132;
  return tiles < sms ? tiles : sms;
}

// The CTA's next tile from the ticket counter, or -1 past the last.
__device__ __forceinline__ int64_t ww_next_tile(int32_t* ticket, int64_t tiles,
                                                int64_t* s_tile) {
  __syncthreads();                     // the table and areas are free
  if (threadIdx.x == 0) *s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  return *s_tile < tiles ? *s_tile : -1;
}

__device__ __forceinline__ uint32_t ww_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(WW_FULL, v, o);
  return v;
}

// Asynchronous copies into shared memory (cp.async): issued without
// waiting, completed for the issuing thread by ww_cp_wait and for the
// CTA by a __syncthreads after it.
__device__ __forceinline__ void ww_cp16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// 4 bytes, or 4 zero bytes when !valid (src is then not read).
__device__ __forceinline__ void ww_cp4(void* dst, const void* src,
                                       bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void ww_cp_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The codebook's 16-bit table into shared memory, by the whole CTA
// (asynchronous).
__device__ __forceinline__ void ww_load_table(uint16_t* tbl,
                                              const uint16_t* __restrict__ src) {
  for (int i = threadIdx.x; i < WW_TABLE_BYTES / 16; i += blockDim.x)
    ww_cp16(tbl + 8 * i, src + 8 * i);
}

// Exclusive prefix (mod 2^32, the reference's int32 cumsum) of a row's
// block bit counts at block b0, summed by the whole CTA; part holds one
// slot a warp.
__device__ __forceinline__ uint32_t ww_row_prefix(const int32_t* __restrict__ nb,
                                                  int64_t b0, uint32_t* part) {
  uint32_t v = 0;
  for (int64_t k = threadIdx.x; k < b0; k += blockDim.x)
    v += static_cast<uint32_t>(nb[k]);
  v = ww_sum(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t t = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += part[w];
  return t;
}

// Segments a lane decodes together (lane j: j, 32 + j, ...), so that
// each step has that many independent lookups in flight.
constexpr int WW_CHAINS = 2;
constexpr int WW_SEGS = 32 * WW_CHAINS;
// A block's segments are decoded from every candidate start instead of
// by more rounds once WW_MAP_AFTER rounds have passed and the starts a
// round moves still span WW_CANDIDATES segments or more (codes that
// resynchronise move a few, close together; with a book of near-equal
// lengths a guess that is off stays off, and the true start would cross
// the span one segment a round); a segment's true start (its first
// codeword boundary at or after its first bit) is one of WW_CANDIDATES
// bits.
constexpr int WW_MAP_AFTER = 3;
constexpr int WW_CANDIDATES = 1 << 4;
// The maps (an entry a segment and candidate) and the chosen starts, in
// the warp's staging row, which they need to fit.
constexpr int WW_MAP_BYTES = 4 * WW_SEGS * (WW_CANDIDATES + 1);

// One segment's reader: it decodes from bit p while its cursor lies
// below `stop`, over the block's words staged in pw (pw[k] is word
// wbase + k). It keeps the two words under the cursor (w0:w1, bit `off`
// of w0 first) and the next three (n1, n2 and pend; pend is loaded on a
// word step and read only on the next, so no step waits on it): a peek
// is one funnel shift, and a code of at most 16 bits moves at most one
// word.
struct WWChain {
  uint32_t w0, w1, n1, n2, pend;
  int32_t wi, off, rel, span, n;
  bool stuck;
};

__device__ __forceinline__ void ww_chain(WWChain& c, const uint32_t* pw,
                                         int64_t wbase, int64_t p,
                                         int64_t stop) {
  c.n = 0;
  c.rel = 0;
  c.stuck = false;
  c.span = p < stop ? static_cast<int32_t>(stop - p) : 0;
  c.off = static_cast<int32_t>(p & 31);
  c.wi = static_cast<int32_t>((p >> 5) - wbase);
  c.w0 = c.w1 = c.n1 = c.n2 = c.pend = 0;
  if (c.span > 0) {
    c.w0 = pw[c.wi];
    c.w1 = pw[c.wi + 1];
    c.n1 = pw[c.wi + 2];
    c.n2 = pw[c.wi + 3];
    c.pend = pw[c.wi + 4];
  }
  c.wi += 5;
}

// One step of a chain, without a branch (an idle chain changes nothing):
// a lookup of length 0 marks the chain stuck and ends it at `stop`.
// kWrite: the symbol to out[n], added to sum and, if 0, to zeros.
template <bool kWrite>
__device__ __forceinline__ void ww_step(WWChain& c, const uint32_t* pw,
                                        const uint16_t* tbl, uint16_t* out,
                                        uint32_t& sum, int32_t& zeros) {
  const bool act = c.rel < c.span;
  const uint32_t e = tbl[__funnelshift_l(c.w1, c.w0, c.off) >> 16];
  const int32_t len = static_cast<int32_t>(e >> WW_SYM_BITS);
  const bool go = act && len != 0;
  c.stuck |= act && len == 0;
  if (kWrite && go) {
    const uint32_t s = e & WW_SYM_MASK;
    out[c.n] = static_cast<uint16_t>(s);
    sum += s;
    zeros += s == 0;
  }
  c.n += go;
  c.rel = act && !go ? c.span : c.rel + (go ? len : 0);
  c.off += go ? len : 0;
  const bool adv = c.off >= 32;
  c.w0 = adv ? c.w1 : c.w0;
  c.w1 = adv ? c.n1 : c.w1;
  c.n1 = adv ? c.n2 : c.n1;
  c.n2 = adv ? c.pend : c.n2;
  c.off -= adv ? 32 : 0;
  if (adv) c.pend = pw[c.wi];
  c.wi += adv;
}

// A lane's WW_CHAINS segments [p[k], stop[k]) decoded together, step for
// step. -> their exits e (p when p >= stop; stop when stuck), symbol
// counts n and stuck flags st; kWrite: the symbols to out[k], their sum
// and zero count to *sum and *zeros.
template <bool kWrite>
__device__ __forceinline__ void ww_segments(
    const uint32_t* pw, int64_t wbase, const uint16_t* tbl, const int64_t* p,
    const int64_t* stop, int64_t* e, int32_t* n, bool* st,
    uint16_t* const* out, uint32_t* sum, int32_t* zeros) {
  WWChain c[WW_CHAINS];
  bool more = false;
#pragma unroll
  for (int k = 0; k < WW_CHAINS; ++k) {
    ww_chain(c[k], pw, wbase, p[k], stop[k]);
    more |= c[k].span > 0;
  }
  uint32_t s = 0;
  int32_t z = 0;
  while (more) {
    more = false;
#pragma unroll
    for (int k = 0; k < WW_CHAINS; ++k) {
      ww_step<kWrite>(c[k], pw, tbl, kWrite ? out[k] : nullptr, s, z);
      more |= c[k].rel < c[k].span;
    }
  }
#pragma unroll
  for (int k = 0; k < WW_CHAINS; ++k) {
    e[k] = p[k] + c[k].rel;
    n[k] = c[k].n;
    st[k] = c[k].stuck;
  }
  if (kWrite) {
    *sum = s;
    *zeros = z;
  }
}

// The fast path of one block by the whole warp (the rule above; (a) is
// the caller's), over the block's words staged in pw by ww_begin: WW_SEGS
// segments, lane j holding segments j, 32 + j, .... Past WW_MAP_AFTER
// rounds, while the starts a round moves span many segments (and where
// the staging row holds the maps), the candidate maps give the fixed
// point instead. True
// when kept: the cnt
// symbols are then in stage[0, cnt), their sum and zero count in
// *sym_sum and *nzero. *rounds: the sync rounds taken (passes before the
// write pass, less one; with the maps, the rounds before them plus
// WW_CANDIDATES).
// The candidate maps: every segment of the lane decoded from each start
// lo + o, o < WW_CANDIDATES, into map[segment][o] = (n << 6) | (stuck <<
// 5) | (exit - hi) (the exit is within 16 bits after hi, or hi itself
// when stuck); lane 0 then composes them from segment 0 at offset 0 (S):
// a segment's start is the previous one's exit. -> the lane's segments'
// starts p, exits e, counts n and stuck flags st, exactly those of the
// fixed point (the same induction as the rounds).
__device__ __forceinline__ void ww_by_maps(const uint32_t* pw, int64_t wbase,
                                           const uint16_t* tbl,
                                           const int64_t* lo, const int64_t* hi,
                                           uint16_t* stage, int64_t* p,
                                           int64_t* e, int32_t* n, bool* st) {
  const int lane = threadIdx.x & 31;
  uint32_t* map = reinterpret_cast<uint32_t*>(stage);
  uint32_t* start = map + WW_SEGS * WW_CANDIDATES;
  for (int o = 0; o < WW_CANDIDATES; ++o) {
    int64_t pc[WW_CHAINS], x[WW_CHAINS];
    int32_t m[WW_CHAINS];
    bool t[WW_CHAINS];
#pragma unroll
    for (int k = 0; k < WW_CHAINS; ++k) pc[k] = lo[k] + o;
    ww_segments<false>(pw, wbase, tbl, pc, hi, x, m, t, nullptr, nullptr,
                       nullptr);
#pragma unroll
    for (int k = 0; k < WW_CHAINS; ++k)
      map[(32 * k + lane) * WW_CANDIDATES + o] =
          (static_cast<uint32_t>(m[k]) << 6) | (t[k] ? 32u : 0u)
          | static_cast<uint32_t>(x[k] - hi[k]);
  }
  __syncwarp();
  if (lane == 0) {
    uint32_t o = 0;
    for (int j = 0; j < WW_SEGS; ++j) {
      start[j] = o;
      o = map[j * WW_CANDIDATES + o] & 31u;
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < WW_CHAINS; ++k) {
    const int j = 32 * k + lane;
    const uint32_t o = start[j], m = map[j * WW_CANDIDATES + o];
    p[k] = lo[k] + o;
    e[k] = hi[k] + (m & 31u);
    n[k] = static_cast<int32_t>(m >> 6);
    st[k] = (m & 32u) != 0;
  }
  __syncwarp();
}

__device__ __forceinline__ bool ww_decode_block(
    int64_t S, int64_t N, int32_t cnt, int64_t bs, const uint16_t* tbl,
    uint16_t* stage, const uint32_t* pw, uint32_t* sym_sum, int32_t* nzero,
    int* rounds) {
  const int lane = threadIdx.x & 31;
  const int64_t wbase = S >> 5;
  const int64_t seg = (N + WW_SEGS - 1) / WW_SEGS;
  const bool maps = 2 * ww_out_stride(bs) >= WW_MAP_BYTES;
  int64_t p[WW_CHAINS], lo[WW_CHAINS], hi[WW_CHAINS], e[WW_CHAINS],
      q[WW_CHAINS], stop[WW_CHAINS];
  int32_t n[WW_CHAINS];
  bool st[WW_CHAINS], redo[WW_CHAINS];
#pragma unroll
  for (int k = 0; k < WW_CHAINS; ++k) {
    const int64_t a = (32 * k + lane) * seg, b = a + seg;
    lo[k] = p[k] = S + (a < N ? a : N);   // segment 0 (lane 0): S
    hi[k] = S + (b < N ? b : N);
    e[k] = 0;
    n[k] = 0;
    st[k] = false;
    redo[k] = true;
  }
  int r = 0;
  for (;;) {
    // a segment whose start did not change keeps its exit
    int64_t x[WW_CHAINS];
    int32_t m[WW_CHAINS];
    bool t[WW_CHAINS];
#pragma unroll
    for (int k = 0; k < WW_CHAINS; ++k) stop[k] = redo[k] ? hi[k] : p[k];
    ww_segments<false>(pw, wbase, tbl, p, stop, x, m, t, nullptr, nullptr,
                       nullptr);
    bool same = true;
#pragma unroll
    for (int k = 0; k < WW_CHAINS; ++k) {
      if (redo[k]) {
        e[k] = x[k];
        n[k] = m[k];
        st[k] = t[k];
      }
      // segment 32k + lane - 1 precedes: the last lane's previous chain
      const int64_t last = k > 0 ? __shfl_sync(WW_FULL, e[k - 1], 31) : S;
      q[k] = __shfl_up_sync(WW_FULL, e[k], 1);
      if (lane == 0) q[k] = last;
      same = same && q[k] == p[k];
    }
    if (__all_sync(WW_FULL, same)) break;
    // the segments whose start moves this round span [first, last]
    int first = WW_SEGS, last = -1;
#pragma unroll
    for (int k = 0; k < WW_CHAINS; ++k) {
      const unsigned m = __ballot_sync(WW_FULL, q[k] != p[k]);
      if (m && first == WW_SEGS) first = 32 * k + __ffs(m) - 1;
      if (m) last = 32 * k + 31 - __clz(m);
    }
    if (maps && r >= WW_MAP_AFTER && last - first >= WW_CANDIDATES) {
      ww_by_maps(pw, wbase, tbl, lo, hi, stage, p, e, n, st);
      r += WW_CANDIDATES;
      break;
    }
#pragma unroll
    for (int k = 0; k < WW_CHAINS; ++k) {
      redo[k] = q[k] != p[k];
      p[k] = q[k];
    }
    ++r;
  }
  *rounds = r;
  int32_t total = 0;
  bool stuck = false;
#pragma unroll
  for (int k = 0; k < WW_CHAINS; ++k) {
    total += n[k];
    stuck = stuck || st[k];
  }
  total = static_cast<int32_t>(ww_sum(static_cast<uint32_t>(total)));
  const int64_t end = __shfl_sync(WW_FULL, e[WW_CHAINS - 1], 31);
  if (__any_sync(WW_FULL, stuck) || total != cnt || end != S + N)
    return false;
  // each segment's offset, in segment order
  uint16_t* out[WW_CHAINS];
  int32_t before = 0;
#pragma unroll
  for (int k = 0; k < WW_CHAINS; ++k) {
    int32_t incl = n[k];
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(WW_FULL, incl, o);
      if (lane >= o) incl += v;
    }
    out[k] = stage + before + incl - n[k];
    before += __shfl_sync(WW_FULL, incl, 31);
  }
  uint32_t s = 0;
  int32_t z = 0;
  ww_segments<true>(pw, wbase, tbl, p, hi, e, n, st, out, &s, &z);
  *sym_sum = ww_sum(s);
  *nzero = static_cast<int32_t>(ww_sum(static_cast<uint32_t>(z)));
  __syncwarp();
  return true;
}

// Rule (a): whether the fast path may run for a block whose first cursor
// is `rel` (relative to its window of `win` words), given a shared area.
__device__ __forceinline__ bool ww_admissible(int64_t rel, int64_t N,
                                              int32_t cnt, int64_t win,
                                              const uint16_t* stage) {
  const int64_t cmax = (win - 2) * 32 + 31;
  return stage != nullptr && cnt >= 1 && N >= cnt
         && N <= static_cast<int64_t>(MAX_CODE_BITS) * cnt && rel >= 0
         && rel + N - 1 <= cmax;
}

// Eight staged codes from position i0 (a multiple of 8 below the row's
// padded stride), as int32.
__device__ __forceinline__ void ww_stage8(const uint16_t* stage, int64_t i0,
                                          int32_t* c) {
  const uint4 raw = *reinterpret_cast<const uint4*>(stage + i0);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c[2 * k] = static_cast<int32_t>(w[k] & 0xffffu);
    c[2 * k + 1] = static_cast<int32_t>(w[k] >> 16);
  }
}

// Eight int32 values to out[i0, i0 + 8) clipped at bs: two 16-byte
// stores where aligned.
__device__ __forceinline__ void ww_put8(int32_t* out, int64_t i0, int64_t bs,
                                        const int32_t* v) {
  int32_t* dst = out + i0;
  if (i0 + 8 <= bs && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    reinterpret_cast<int4*>(dst)[0] = make_int4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<int4*>(dst)[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i0 + k < bs) dst[k] = v[k];
  }
}

// The block's codes from the staging row to out[0, bs), zero past cnt,
// by the warp in coalesced stores.
__device__ __forceinline__ void ww_store_codes(const uint16_t* stage,
                                               int32_t cnt, int64_t bs,
                                               int32_t* out) {
  const int lane = threadIdx.x & 31;
  for (int64_t i0 = lane * 8; i0 < bs; i0 += 256) {
    int32_t c[8];
    ww_stage8(stage, i0, c);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i0 + k >= cnt) c[k] = 0;
    ww_put8(out, i0, bs, c);
  }
}

__device__ __forceinline__ void ww_zero(int64_t bs, int32_t* out) {
  for (int64_t i = threadIdx.x & 31; i < bs; i += 32) out[i] = 0;
}

// The payload area of a warp's shared area (after its staging row).
__device__ __forceinline__ uint32_t* ww_words_of(uint16_t* stage, int64_t bs) {
  return reinterpret_cast<uint32_t*>(stage + ww_out_stride(bs));
}

// Before the CTA's wait: whether the fast path may run for a block whose
// first cursor is `rel` in the window [foff, foff + win) of a row of W
// words (rule (a); `stage` is the warp's shared area or nullptr), and if
// so the block's words, zero at and past W, fetched asynchronously into
// the area: word S/32 + k at k, as far as any lane's reader looks ahead.
__device__ __forceinline__ bool ww_begin(const uint32_t* __restrict__ row,
                                         int64_t W, int64_t foff, int64_t win,
                                         int32_t rel, int64_t N, int32_t cnt,
                                         int64_t bs, uint16_t* stage) {
  if (!ww_admissible(rel, N, cnt, win, stage)) return false;
  const int64_t S = foff * 32 + rel, wbase = S >> 5;
  const int64_t nw = ((S + N + 15) >> 5) + 5 - wbase;
  uint32_t* pw = ww_words_of(stage, bs);
  for (int64_t k = threadIdx.x & 31; k < nw; k += 32) {
    const bool in = wbase + k < W;
    ww_cp4(pw + k, row + (in ? wbase + k : 0), in);
  }
  return true;
}

// After the wait: one block with cnt >= 1 by the warp, either path: fast
// into `stage` when ww_begin admitted it (`adm`) and the rule keeps it
// (true), or walk_lane into out[0, bs) against the 32-bit table (false).
// Updates the CTA's stats.
__device__ __forceinline__ bool ww_block(
    const uint32_t* __restrict__ row, int64_t W, int64_t foff, int64_t win,
    int32_t rel, int64_t N, int32_t cnt, int64_t bs, bool adm,
    const uint16_t* tbl, const int32_t* __restrict__ table32,
    uint16_t* stage, int32_t* out, uint32_t* sym_sum, int32_t* nzero,
    int* s_stats) {
  const int lane = threadIdx.x & 31;
  *sym_sum = 0;
  *nzero = 0;
  int rounds = 0;
  if (adm && ww_decode_block(foff * 32 + rel, N, cnt, bs, tbl, stage,
                             ww_words_of(stage, bs), sym_sum, nzero,
                             &rounds)) {
    if (lane == 0) {
      atomicAdd(s_stats + WW_FAST, 1);
      atomicMax(s_stats + WW_ROUNDS, rounds);
    }
    return true;
  }
  if (lane == 0) {
    walk_lane(row, W, foff, win, rel, table32, cnt, static_cast<int32_t>(bs),
              out);
    atomicAdd(s_stats + WW_EXACT, 1);
  }
  __syncwarp();
  return false;
}

__device__ __forceinline__ void ww_flush_stats(const int* s_stats,
                                               int32_t* stats) {
  if (threadIdx.x == 0) {
    if (s_stats[WW_EXACT]) atomicAdd(stats + WW_EXACT, s_stats[WW_EXACT]);
    if (s_stats[WW_FAST]) atomicAdd(stats + WW_FAST, s_stats[WW_FAST]);
    atomicMax(stats + WW_ROUNDS, s_stats[WW_ROUNDS]);
  }
}

}  // namespace ceaz
