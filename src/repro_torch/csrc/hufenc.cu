// Huffman packers: per-chunk codebook gather + contiguous MSB-first bit
// packing into u32 words, plus per-block bit counts.
//
// Replaces three TPU kernels of src/repro/kernels/hufenc/kernel.py:
//
//   * gather_pack_tiled (:267; block sums at :290, pack at :333), the
//     fused route's pass 2 — block_sums_kernel + pack_kernel;
//   * gather_pack (:164; pallas_call at :178), the same output with one
//     program per chunk — gather_pack_kernel;
//   * hufenc (:344; pallas_call at :353), the serial per-block packer,
//     one padded row per stream block — blocks_pack_kernel, with
//     stitch_kernel laying the rows end to end into the host stream
//     (the reference does that on the host, hufenc/ops.py::
//     to_host_stream).
//
// The TPU kernels compose every OUTPUT word from a window of up to 33
// candidate symbols found by a binary search over bit offsets (or, in
// hufenc, walk a block's symbols one by one), because a TPU program
// cannot scatter. Hopper can: here every SYMBOL places its own bits, and
// since the bits of distinct symbols are disjoint, OR is order-free and
// the result is deterministic whatever order the atomicOr's land in.
// Each thread owns a run of consecutive symbols, a block-wide exclusive
// scan of the runs' bit counts places each run, and the thread ORs
// whole words it composed in a register into the zeroed payload
// (pack_run); only words shared with a neighbouring run (or spanned by a
// symbol) see more than one atomicOr.
//
//   gather_pack_tiled: (a) block_sums_kernel, one CTA per (chunk, block):
//     the block's code bits over valid symbols; (b) torch glue in the
//     wrapper: an exclusive int32 cumsum of those -> each block's first
//     bit; (c) pack_kernel, one CTA per (chunk, block).
//   gather_pack: one launch of C x ceil(cv/4096) CTAs, one a 4096-symbol
//     tile of a row; the tiles' first bits come from a decoupled
//     look-back over per-tile status words (below, before the kernel).
//     The tile packs from shared memory into a shared buffer and writes
//     it out coalesced: its own device functions (gp_*), the other
//     kernels' pack_run untouched.
//   hufenc: one CTA per stream block packs the block into its own row
//     (the FPGA's N pipelines, one per block) and writes the block's bit
//     count; the stitch kernel then ORs each row word into the output at
//     the block's exclusive-cumsum bit offset (int64), so an output word
//     may gather bits of any number of blocks.
// Bits past w32*32 (a row's width) are dropped, as the reference
// truncates its payload.
//
// Bound on the H100: bytes — each value is read once as a 4 B code (and
// 1 B valid flag), and the payload (~2-16 bits a value) is written once
// (hufenc: written as rows, read and written again by the stitch); the
// codebook rows (8 KB per chunk) sit in shared memory.
//
// gather_pack is the staged route's packer of one chunk (2^15-2^17
// values), where that bound is well under a microsecond: there the launch
// and the latency of one CTA's chain of steps bound it. What held the
// first design (one CTA a row, walking it tile after tile at ~13 us a
// tile on 1 SM of 132) and what this one does instead:
//   * the grid: a tile a CTA, so a 2^15 chunk spans 8 SMs and a 2^23 one
//     fills all 132, in one launch (no second pass for the prefix sum);
//   * the loads: a tile's codes and flags are read once, as 16-byte code
//     vectors and 4-byte flag words (scalar at an unaligned head and
//     tail), into a shared table of (code, length) that the block counts
//     and the pack both read: nothing is read from global memory twice;
//   * the block counts: no division a symbol — a run steps its next
//     block boundary; blocks of >= 16 symbols are summed in shared memory
//     and added with one global atomicAdd a (tile, block);
//   * the pack: a run's words wholly inside its bits are stored to the
//     shared buffer, only words shared with a neighbouring run are ORed;
//     the buffer goes out shifted to the tile's first bit, stores for the
//     words wholly inside the tile and atomicOr for its two edge words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NUM_SYMBOLS = 1024;

__device__ __forceinline__ int clamp_code(int32_t code) {
  // the reference gathers with jnp indexing, which clamps out-of-range
  // indices; dual-quant codes are always in range
  return code < 0 ? 0 : (code >= NUM_SYMBOLS ? NUM_SYMBOLS - 1 : code);
}

// Block-wide exclusive scan (and total) of one int per thread.
__device__ int32_t block_exclusive_scan(int32_t v, int32_t* total) {
  __shared__ int32_t warp_sums[THREADS / 32];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t s = lane < THREADS / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int32_t y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < THREADS / 32) warp_sums[lane] = s;  // inclusive per warp
  }
  __syncthreads();
  int32_t before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[THREADS / 32 - 1];
  return before + x - v;
}

__global__ void block_sums_kernel(const int32_t* __restrict__ codes,
                                  const uint8_t* __restrict__ valid,
                                  const int32_t* __restrict__ lengths,
                                  int64_t cv, int bs, int64_t nblocks,
                                  int32_t* block_nbits) {
  __shared__ int32_t ln[NUM_SYMBOLS];
  int64_t b = blockIdx.x;
  int64_t c = blockIdx.y;
  for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS)
    ln[s] = lengths[c * NUM_SYMBOLS + s];
  __syncthreads();
  const int32_t* crow = codes + c * cv;
  const uint8_t* vrow = valid + c * cv;
  int32_t sum = 0;
  for (int i = threadIdx.x; i < bs; i += THREADS) {
    int64_t p = b * bs + i;
    if (p < cv && vrow[p]) sum += ln[clamp_code(crow[p])];
  }
  int32_t total;
  block_exclusive_scan(sum, &total);
  if (threadIdx.x == 0) block_nbits[c * nblocks + b] = total;
}

__device__ __forceinline__ void flush(uint32_t* row, int64_t w32, int64_t w,
                                      uint32_t acc) {
  if (w >= 0 && w < w32 && acc != 0) atomicOr(row + w, acc);
}

// Code bits of the valid symbols [p0, p1) of a row (vrow null: all valid).
__device__ __forceinline__ int32_t run_bits(const int32_t* crow,
                                            const uint8_t* vrow, int64_t p0,
                                            int64_t p1, const int32_t* ln) {
  int32_t bits = 0;
  for (int64_t p = p0; p < p1; ++p)
    if (!vrow || vrow[p]) bits += ln[clamp_code(crow[p])];
  return bits;
}

// ORs the codewords of the valid symbols [p0, p1) of a row into `row`
// from bit `bit` on, composing whole words in a register.
__device__ void pack_run(const int32_t* crow, const uint8_t* vrow,
                         int64_t p0, int64_t p1, const int32_t* ln,
                         const uint32_t* cw, int64_t bit, uint32_t* row,
                         int64_t w32) {
  int64_t cur = -1;
  uint32_t acc = 0;
  for (int64_t p = p0; p < p1; ++p) {
    if (vrow && !vrow[p]) continue;
    int code = clamp_code(crow[p]);
    int len = ln[code];
    if (len <= 0) continue;
    uint32_t v = cw[code];
    int64_t w = bit >> 5;
    int off = static_cast<int>(bit & 31);
    bit += len;
    if (w != cur) {
      flush(row, w32, cur, acc);
      cur = w;
      acc = 0;
    }
    if (off + len <= 32) {
      acc |= v << (32 - off - len);
    } else {
      acc |= v >> (off + len - 32);
      flush(row, w32, cur, acc);
      cur = w + 1;
      acc = v << (64 - off - len);
    }
  }
  flush(row, w32, cur, acc);
}

__device__ __forceinline__ void load_tables(const int32_t* lengths,
                                            const int32_t* cwords,
                                            int32_t* ln, uint32_t* cw) {
  for (int s = threadIdx.x; s < NUM_SYMBOLS; s += THREADS) {
    ln[s] = lengths[s];
    cw[s] = static_cast<uint32_t>(cwords[s]);
  }
  __syncthreads();
}

__global__ void pack_kernel(const int32_t* __restrict__ codes,
                            const uint8_t* __restrict__ valid,
                            const int32_t* __restrict__ lengths,
                            const int32_t* __restrict__ cwords, int64_t cv,
                            int bs, int64_t nblocks,
                            const int32_t* __restrict__ block_base,
                            int64_t w32, uint32_t* words) {
  __shared__ int32_t ln[NUM_SYMBOLS];
  __shared__ uint32_t cw[NUM_SYMBOLS];
  int64_t b = blockIdx.x;
  int64_t c = blockIdx.y;
  load_tables(lengths + c * NUM_SYMBOLS, cwords + c * NUM_SYMBOLS, ln, cw);
  const int32_t* crow = codes + c * cv;
  const uint8_t* vrow = valid + c * cv;
  int per = (bs + THREADS - 1) / THREADS;
  int64_t p0 = b * bs + static_cast<int64_t>(threadIdx.x) * per;
  int64_t p1 = min(b * bs + min(static_cast<int64_t>(threadIdx.x + 1) * per,
                                static_cast<int64_t>(bs)),
                   cv);
  int32_t total;
  int32_t before = block_exclusive_scan(run_bits(crow, vrow, p0, p1, ln),
                                        &total);
  // global bit offsets are int32 in the reference (its cumsum dtype)
  int64_t bit = static_cast<int64_t>(block_base[c * nblocks + b]) + before;
  pack_run(crow, vrow, p0, p1, ln, cw, bit, words + c * w32, w32);
}

// ---- gather_pack: one launch spread over the card --------------------------
//
// A row of cv symbols is cut into tiles of GP_TILE symbols, one CTA a
// tile, every row's tiles in one grid. A tile's first bit is the sum of
// the bits of the row's tiles before it; the CTAs find it in one pass
// with a decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016): a tile publishes its
// aggregate as soon as it has counted its bits, then its inclusive prefix
// once it knows it, each as one 64-bit status word (flag and value read
// by one load). A tile takes its index from a per-row ticket, not from
// blockIdx, so it only ever waits on tiles that are already running.
// Meanwhile it packs its bits into shared memory from bit 0; the prefix
// only shifts them on the way out.
constexpr int GP_PER = 16;                          // symbols a thread's run
constexpr int GP_TILE = THREADS * GP_PER;           // 4096 symbols a tile
constexpr int GP_SLOTS = GP_TILE + GP_TILE / GP_PER;  // a pad slot a run
constexpr int GP_WORDS = GP_TILE;                   // <= 32 bits a symbol
constexpr int GP_BLOCKS = GP_TILE / 16 + 2;         // blocks of >= 16 symbols
constexpr unsigned long long ST_AGG = 1ull << 62;   // aggregate published
constexpr unsigned long long ST_PRE = 2ull << 62;   // inclusive prefix
constexpr unsigned long long ST_VAL = ST_AGG - 1;

// Shared slot of a tile's symbol: each thread's run of 16 consecutive
// symbols sits 17 slots after the previous one, so the 32 runs a warp
// walks at once fall in 32 distinct banks.
__device__ __forceinline__ int gp_slot(int i) { return i + i / GP_PER; }

// One symbol into the tile's shared table: its clamped code in the low
// 16 bits, its code length (0 when invalid) above.
__device__ __forceinline__ void gp_put(int32_t* sym, const int32_t* ln,
                                       int i, int32_t code, uint32_t ok) {
  const int k = clamp_code(code);
  sym[gp_slot(i)] = k | ((ok ? ln[k] : 0) << 16);
}

__device__ __forceinline__ void gp_publish(unsigned long long* st,
                                           unsigned long long v) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(st) = v;
}

// A composed word of a run into the tile's buffer: stored when it lies
// wholly inside the run's bits [b0, b1) (no other thread has bits there),
// ORed when it is shared with a neighbouring run.
__device__ __forceinline__ void gp_emit(uint32_t* buf, int w, uint32_t acc,
                                        int b0, int b1) {
  if (acc == 0 || w < 0 || w >= GP_WORDS) return;
  if (32 * w >= b0 && 32 * w + 32 <= b1)
    buf[w] = acc;
  else
    atomicOr(buf + w, acc);
}

// Packs the tile's symbols [r0, r1) into `buf` from tile bit `bit` on,
// composing whole words in a register; `bits` is the run's bit count.
__device__ void gp_compose(const int32_t* sym, const uint32_t* cw, int r0,
                           int r1, int bit, int bits, uint32_t* buf) {
  const int b0 = bit, b1 = bit + bits;
  int cur = -1;
  uint32_t acc = 0;
  for (int i = r0; i < r1; ++i) {
    const int32_t s = sym[gp_slot(i)];
    const int len = s >> 16;
    if (len <= 0) continue;
    const uint32_t v = cw[s & 0xffff];
    const int w = bit >> 5;
    const int off = bit & 31;
    bit += len;
    if (w != cur) {
      gp_emit(buf, cur, acc, b0, b1);
      cur = w;
      acc = 0;
    }
    if (off + len <= 32) {
      acc |= v << (32 - off - len);
    } else {
      acc |= v >> (off + len - 32);
      gp_emit(buf, cur, acc, b0, b1);
      cur = w + 1;
      acc = v << (64 - off - len);
    }
  }
  gp_emit(buf, cur, acc, b0, b1);
}

__global__ void __launch_bounds__(THREADS)
gather_pack_kernel(const int32_t* __restrict__ codes,
                   const uint8_t* __restrict__ valid,
                   const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ cwords, int64_t cv, int64_t bs,
                   int64_t nblocks, int64_t tiles, int64_t w32,
                   uint32_t* words, int32_t* block_nbits,
                   unsigned long long* status, int32_t* tickets) {
  __shared__ int32_t ln[NUM_SYMBOLS];
  __shared__ uint32_t cw[NUM_SYMBOLS];
  __shared__ int32_t sym[GP_SLOTS];
  __shared__ __align__(16) uint32_t buf[GP_WORDS];
  __shared__ int32_t bsum[GP_BLOCKS];
  __shared__ int64_t s_tile, s_prefix;
  const int tid = threadIdx.x;
  const int64_t c = blockIdx.x / tiles;
  if (tid == 0) s_tile = atomicAdd(tickets + c, 1);
  for (int s = tid; s < NUM_SYMBOLS; s += THREADS) {
    ln[s] = lengths[c * NUM_SYMBOLS + s];
    cw[s] = static_cast<uint32_t>(cwords[c * NUM_SYMBOLS + s]);
  }
  for (int s = tid; s < GP_WORDS / 4; s += THREADS)
    reinterpret_cast<uint4*>(buf)[s] = make_uint4(0, 0, 0, 0);
  for (int s = tid; s < GP_BLOCKS; s += THREADS) bsum[s] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t t0 = tile * GP_TILE;                    // row-relative
  const int n = static_cast<int>(min(static_cast<int64_t>(GP_TILE), cv - t0));

  // the tile's codes and flags, read from global memory once: 4 codes as
  // one 16-byte vector and their flags as one word where aligned, scalar
  // at the head and tail (a row starts at 4*c*cv bytes)
  const int64_t g0 = c * cv + t0, g1 = g0 + n;
  const int64_t skew = (reinterpret_cast<uintptr_t>(codes + g0) >> 2) & 3;
  const int64_t a0 = min(g0 + ((4 - skew) & 3), g1);
  const int64_t a1 = a0 + ((g1 - a0) & ~static_cast<int64_t>(3));
  if ((reinterpret_cast<uintptr_t>(valid + a0) & 3) == 0) {
    if (tid < a0 - g0) gp_put(sym, ln, tid, codes[g0 + tid], valid[g0 + tid]);
    if (tid < g1 - a1)
      gp_put(sym, ln, static_cast<int>(a1 - g0) + tid, codes[a1 + tid],
             valid[a1 + tid]);
    const int4* c4 = reinterpret_cast<const int4*>(codes + a0);
    const uint32_t* f4 = reinterpret_cast<const uint32_t*>(valid + a0);
    const int i0 = static_cast<int>(a0 - g0);
    const int nv = static_cast<int>((a1 - a0) >> 2);
    for (int k = tid; k < nv; k += THREADS) {
      const int4 v = __ldg(c4 + k);
      const uint32_t f = __ldg(f4 + k);
      const int i = i0 + 4 * k;
      gp_put(sym, ln, i, v.x, f & 0xffu);
      gp_put(sym, ln, i + 1, v.y, (f >> 8) & 0xffu);
      gp_put(sym, ln, i + 2, v.z, (f >> 16) & 0xffu);
      gp_put(sym, ln, i + 3, v.w, f >> 24);
    }
  } else {
    for (int i = tid; i < n; i += THREADS)
      gp_put(sym, ln, i, codes[g0 + i], valid[g0 + i]);
  }
  __syncthreads();

  // each thread's run [r0, r1): its bits, and its share of each stream
  // block, found by stepping a block boundary (no division a symbol);
  // blocks of >= 16 symbols are summed in shared memory first, one global
  // atomicAdd a (tile, block), smaller ones straight into the output
  const int r0 = min(tid * GP_PER, n), r1 = min(r0 + GP_PER, n);
  const int64_t fb = t0 / bs;
  const int64_t nlb = (t0 + n - 1) / bs - fb + 1;
  const bool smem_blocks = nlb <= GP_BLOCKS;
  int32_t* nb = block_nbits + c * nblocks;
  int32_t mybits = 0;
  if (r0 < r1) {
    int64_t p = t0 + r0;
    int64_t blk = p / bs, nxt = (blk + 1) * bs;
    int32_t bb = 0;
    for (int i = r0; i < r1; ++i, ++p) {
      if (p == nxt) {
        if (bb) atomicAdd(smem_blocks ? bsum + (blk - fb) : nb + blk, bb);
        ++blk;
        nxt += bs;
        bb = 0;
      }
      const int32_t l = sym[gp_slot(i)] >> 16;
      bb += l;
      mybits += l;
    }
    if (bb) atomicAdd(smem_blocks ? bsum + (blk - fb) : nb + blk, bb);
  }
  int32_t total;
  const int32_t before = block_exclusive_scan(mybits, &total);
  unsigned long long* st = status + c * tiles;
  if (tid == 0)
    gp_publish(st + tile, (tile == 0 ? ST_PRE : ST_AGG)
                              | static_cast<unsigned long long>(total));

  // warp 0 looks back over the row's earlier tiles, 32 at a time, for
  // this tile's first bit (int64), and publishes its inclusive prefix
  if (tid < 32) {
    int64_t excl = 0;
    if (tile > 0) {
      for (int64_t j = tile - 1;; j -= 32) {
        const int64_t idx = j - tid;
        unsigned long long s = ST_PRE;           // before the row: prefix 0
        if (idx >= 0) {
          do {
            s = *reinterpret_cast<volatile unsigned long long*>(st + idx);
          } while ((s >> 62) == 0);
        }
        const unsigned pre = __ballot_sync(0xffffffffu, (s >> 62) == 2);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        int64_t v = tid <= stop ? static_cast<int64_t>(s & ST_VAL) : 0;
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (pre) break;
      }
      if (tid == 0)
        gp_publish(st + tile,
                   ST_PRE | static_cast<unsigned long long>(excl + total));
    }
    if (tid == 0) s_prefix = excl;
  }

  gp_compose(sym, cw, r0, r1, before, mybits, buf);
  __syncthreads();

  if (smem_blocks)
    for (int i = tid; i < nlb; i += THREADS)
      if (bsum[i]) atomicAdd(nb + fb + i, bsum[i]);
  if (total <= 0) return;
  // out to the row at the tile's first bit, coalesced: a word wholly
  // inside the tile's bits is stored, the two edge words (shared with the
  // neighbouring tiles) are ORed; bits past w32 words are dropped
  const int64_t s0 = s_prefix;
  const int o = static_cast<int>(s0 & 31);
  const int64_t w0 = s0 >> 5;
  const int nbuf = (total + 31) >> 5;
  const int nout = (o + total + 31) >> 5;
  uint32_t* row = words + c * w32;
  for (int j = tid; j < nout && w0 + j < w32; j += THREADS) {
    const uint32_t hi = j < nbuf ? buf[j] : 0u;
    uint32_t v = hi;
    if (o != 0) v = (hi >> o) | (j > 0 ? buf[j - 1] << (32 - o) : 0u);
    if (32 * j >= o && 32 * (j + 1) <= o + total)
      row[w0 + j] = v;
    else if (v != 0)
      atomicOr(row + w0 + j, v);
  }
}

__global__ void blocks_pack_kernel(const int32_t* __restrict__ codes,
                                   int64_t n,
                                   const int32_t* __restrict__ lengths,
                                   const int32_t* __restrict__ cwords,
                                   int64_t bs, int64_t R, uint32_t* rows,
                                   int32_t* nbits) {
  __shared__ int32_t ln[NUM_SYMBOLS];
  __shared__ uint32_t cw[NUM_SYMBOLS];
  load_tables(lengths, cwords, ln, cw);
  int64_t b = blockIdx.x;
  int64_t end = min((b + 1) * bs, n);
  int64_t per = (bs + THREADS - 1) / THREADS;
  int64_t p0 = min(b * bs + threadIdx.x * per, end);
  int64_t p1 = min(p0 + per, end);
  int32_t total;
  int32_t before = block_exclusive_scan(run_bits(codes, nullptr, p0, p1, ln),
                                        &total);
  pack_run(codes, nullptr, p0, p1, ln, cw, before, rows + b * R, R);
  if (threadIdx.x == 0) nbits[b] = total;
}

__global__ void stitch_kernel(const uint32_t* __restrict__ rows,
                              const int32_t* __restrict__ nbits,
                              const int64_t* __restrict__ first_bit,
                              int64_t R, int64_t n_out, uint32_t* out) {
  int64_t b = blockIdx.x;
  const uint32_t* row = rows + b * R;
  int64_t nw = min((static_cast<int64_t>(nbits[b]) + 31) >> 5, R);
  int64_t g0 = first_bit[b];
  for (int64_t j = threadIdx.x; j < nw; j += THREADS) {
    uint32_t v = row[j];                // bits past nbits are zero
    if (v == 0) continue;
    int64_t g = g0 + 32 * j;
    int64_t w = g >> 5;
    int s = static_cast<int>(g & 31);
    if (w < n_out) atomicOr(out + w, v >> s);
    if (s != 0 && w + 1 < n_out) {
      uint32_t u = v << (32 - s);
      if (u != 0) atomicOr(out + w + 1, u);
    }
  }
}

}  // namespace

// words must be zeroed by the caller; block_base is the exclusive cumsum
// of block_nbits (computed between the two entries).
extern "C" int ceaz_hufenc_block_sums(const void* codes, const void* valid,
                                      const void* lengths, int64_t C,
                                      int64_t cv, int64_t bs,
                                      int64_t nblocks, void* block_nbits,
                                      void* stream) {
  if (C > 0 && nblocks > 0) {
    dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(C));
    block_sums_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(lengths), cv, static_cast<int>(bs),
        nblocks, static_cast<int32_t*>(block_nbits));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ceaz_hufenc_pack(const void* codes, const void* valid,
                                const void* lengths, const void* cwords,
                                int64_t C, int64_t cv, int64_t bs,
                                int64_t nblocks, const void* block_base,
                                int64_t w32, void* words, void* stream) {
  if (C > 0 && nblocks > 0 && w32 > 0) {
    dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(C));
    pack_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(cwords), cv, static_cast<int>(bs), nblocks,
        static_cast<const int32_t*>(block_base), w32,
        static_cast<uint32_t*>(words));
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of gather_pack's look-back scratch for C rows of cv symbols: one
// 64-bit status word a tile (C*tiles, tiles = ceil(cv / GP_TILE)), then
// one int32 ticket a row (C). The wrapper sizes its buffer with it.
extern "C" int64_t ceaz_gather_pack_scratch_bytes(int64_t C, int64_t cv) {
  return 8 * C * ((cv + GP_TILE - 1) / GP_TILE) + 4 * C;
}

// words (C, w32), block_nbits (C, nblocks) and the 8-byte aligned
// scratch (its layout above) lie in one buffer of `bytes` bytes from
// `words` on, which this entry zeroes on the stream before the launch.
extern "C" int ceaz_gather_pack(const void* codes, const void* valid,
                                const void* lengths, const void* cwords,
                                int64_t C, int64_t cv, int64_t bs,
                                int64_t nblocks, int64_t w32, void* words,
                                void* block_nbits, void* scratch,
                                int64_t bytes, void* stream) {
  if (C > 0 && cv > 0) {
    const int64_t tiles = (cv + GP_TILE - 1) / GP_TILE;
    if (bs <= 0 || C * tiles > INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(words, 0, bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto* status = static_cast<unsigned long long*>(scratch);
    gather_pack_kernel<<<static_cast<unsigned>(C * tiles), THREADS, 0, st>>>(
        static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(cwords), cv, bs, nblocks, tiles, w32,
        static_cast<uint32_t*>(words), static_cast<int32_t*>(block_nbits),
        status, reinterpret_cast<int32_t*>(status + C * tiles));
  }
  return static_cast<int>(cudaGetLastError());
}

// rows (nblocks, R) must be zeroed by the caller; lengths/cwords (1024,).
extern "C" int ceaz_hufenc_blocks(const void* codes, int64_t n,
                                  const void* lengths, const void* cwords,
                                  int64_t bs, int64_t nblocks, int64_t R,
                                  void* rows, void* nbits, void* stream) {
  if (nblocks > 0) {
    blocks_pack_kernel<<<static_cast<unsigned>(nblocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes), n,
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(cwords), bs, R,
        static_cast<uint32_t*>(rows), static_cast<int32_t*>(nbits));
  }
  return static_cast<int>(cudaGetLastError());
}

// out (n_out,) must be zeroed by the caller; first_bit is the exclusive
// int64 cumsum of nbits.
extern "C" int ceaz_hufenc_stitch(const void* rows, const void* nbits,
                                  const void* first_bit, int64_t nblocks,
                                  int64_t R, int64_t n_out, void* out,
                                  void* stream) {
  if (nblocks > 0) {
    stitch_kernel<<<static_cast<unsigned>(nblocks), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(rows),
        static_cast<const int32_t*>(nbits),
        static_cast<const int64_t*>(first_bit), R, n_out,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
