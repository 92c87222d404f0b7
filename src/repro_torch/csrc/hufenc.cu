// Huffman packers: per-chunk codebook gather + contiguous MSB-first bit
// packing into u32 words, plus per-block bit counts.
//
// Replaces three TPU kernels of src/repro/kernels/hufenc/kernel.py:
//
//   * gather_pack_tiled (:267; block sums at :290, pack at :333), the
//     fused route's pass 2, and gather_pack (:164; pallas_call at :178),
//     the same function with one program per chunk: both are
//     gather_pack_kernel, one launch (the wrappers count it under the
//     TPU kernel each replaces);
//   * hufenc (:344; pallas_call at :353), the serial per-block packer,
//     one padded row per stream block — blocks_pack_kernel, with
//     stitch_kernel laying the rows end to end into the host stream
//     (the reference does that on the host, hufenc/ops.py::
//     to_host_stream).
//
// The TPU kernels compose every OUTPUT word from a window of up to 33
// candidate symbols found by a binary search over bit offsets (or, in
// hufenc, walk a block's symbols one by one), because a TPU program
// cannot scatter. Hopper can: here every run of symbols places its own
// bits, and since the bits of distinct symbols are disjoint, OR is
// order-free and the result is deterministic whatever order the ORs land
// in. Bits past w32*32 (a row's width) are dropped, as the reference
// truncates its payload. Code lengths are those of a codebook, in
// [0, 32].
//
//   gather_pack_kernel: persistent CTAs take 4096-symbol tiles of the
//     rows by ticket; each tile's first bit comes from a decoupled
//     look-back over per-tile status words (below, before the kernel).
//   blocks_pack_kernel: one CTA per stream block packs the block into its
//     own row (the FPGA's N pipelines, one per block) and writes the
//     block's bit count (pack_run); the stitch kernel then ORs each row
//     word into the output at the block's exclusive-cumsum bit offset
//     (int64), so an output word may gather bits of any number of blocks.
//
// Bound on the H100: bytes — each value is read once as a 4 B code and a
// 1 B valid flag, and the payload (~2-16 bits a value) is written once
// (hufenc: written as rows, read and written again by the stitch); the
// codebook rows (8 KB per chunk) sit in shared memory.
//
// What held gather_pack_kernel's first design back (a CTA a tile, each
// thread's 16 symbols staged in a shared table, then counted, then packed
// from it; warp 0 looking back 32 tiles a step while the others packed;
// clock64 and globaltimer stamps in a scratch build on the main path's
// pass-2 inputs): long serial phases a tile — the book reloaded by every
// tile, the symbols read from global memory into the shared table and
// from it twice more, a count loop that stepped block boundaries with
// 64-bit positions a symbol, and a look-back that walked back a row of
// ~1600 tiles 32 at a time. What this design does instead:
//   * registers, not a shared table: each thread loads its own run of 16
//     symbols (four 16-byte code vectors, one 16-byte flag vector) and
//     keeps it in registers from the count to the pack, so a symbol is
//     read once from global memory and its code length once from the
//     book; the pack loop is unrolled, its 16 codeword lookups
//     independent;
//   * the stream blocks' bits from the runs' scanned first bits (a run
//     lies in one block when the block size is a multiple of 16): one
//     atomicAdd a (tile, block), nothing a symbol;
//   * the whole CTA looks back, 512 tiles a step, after it has packed;
//   * persistent CTAs: a CTA keeps the row's book while its next tile has
//     the same row (the one-row phases load it once a CTA), and takes its
//     next ticket while it packs.
// What holds it back now (the same stamps): a tile still lives through
// its phases in order — load and count, scan, pack, look-back, write —
// and the CTAs on an SM move through them nearly in step, so the memory
// system idles while they pack and look back, and the issue slots while
// they load. Measured and slower on the card: staging the next tile's
// symbols in shared memory by cp.async while packing the current one
// (with and without counting it ahead), a control warp that looks back
// while eight pack, CTAs of 64 and 128 threads, a 32-tile and a 128-tile
// warp look-back, backoff in its spin (PERF.md section 6).
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

// ---- gather_pack_tiled and gather_pack: one launch, a look-back -----------
//
// A row of cv symbols is cut into tiles of GP_TILE symbols, every row's
// tiles in one ticket order (row after row). A grid of persistent CTAs,
// as many as fit on the card at once, takes the tiles one ticket at a
// time: a CTA only ever waits on tiles whose tickets were taken before
// its own, by CTAs that are running, so the grid needs no co-residency
// guarantee. A tile's first bit is the sum of the bits of the row's tiles
// before it, found in one pass by a decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016): a tile publishes its aggregate as soon as it has counted its
// bits, then its inclusive prefix once it knows it, each as one 64-bit
// status word (flag and value read by one load).
//
// Prefixes are int64 here; the reference's are an int32 cumsum
// (hufenc/kernel.py:304). The two agree while a row's bits stay below
// 2^31. Only a prefix below w32*32 places a stored bit (a tile whose
// first bit is at or past w32*32 writes nothing), and every caller's w32
// is at most runtime/fused.py::words_capacity(cv), 16*cv/32 + 4 words, so
// for a row of fewer than 2^27 - 8 values every prefix that places a bit
// is below 2^31.
//
// Per tile, each thread owns a run of GP_PER consecutive symbols and
// keeps it in registers from the load to the pack: it loads the run
// itself (four 16-byte code vectors and one 16-byte flag vector where
// aligned, symbol by symbol at a row's unaligned or short runs), looks
// each code's length up in the row's book in shared memory, and sums the
// run's bits; a block-wide scan places the runs; the tile publishes its
// aggregate; each thread composes its run's codewords into whole words in
// a register and stores them to the tile's shared buffer (ORed only where
// a word is shared with a neighbouring run); then the whole CTA looks
// back, THREADS * GP_LOOK tiles a step, for the tile's first bit; the
// buffer goes out shifted to it, stored where a word lies wholly inside
// the tile's bits, ORed at the tile's two edge words. A CTA keeps the
// book while its next tile has the same row, and takes its next ticket
// while it packs.
constexpr int GP_PER = 16;                          // symbols a thread's run
constexpr int GP_TILE = THREADS * GP_PER;           // 4096 symbols a tile
constexpr int GP_WORDS = GP_TILE;                   // <= 32 bits a symbol
constexpr int GP_LOOK = 2;                          // status words a thread
constexpr int GP_CTAS_PER_SM = 4;                   // launch bounds below
constexpr unsigned long long ST_AGG = 1ull << 62;   // aggregate published
constexpr unsigned long long ST_PRE = 2ull << 62;   // inclusive prefix
constexpr unsigned long long ST_VAL = ST_AGG - 1;

__device__ __forceinline__ void gp_publish(unsigned long long* st,
                                           unsigned long long v) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(st) = v;
}

// Tile i's status word, read past the caches.
__device__ __forceinline__ unsigned long long gp_status(
    const unsigned long long* st, int64_t i) {
  return *reinterpret_cast<const volatile unsigned long long*>(st + i);
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

// The run's symbols from the row into sym[] (the clamped code), with
// each symbol's length in the high half (0 when invalid or past the
// tile's n symbols) -> the run's bits. g: the run's first symbol's global
// index; i0: its index in the tile.
__device__ __forceinline__ int32_t gp_load_run(
    const int32_t* __restrict__ codes, const uint8_t* __restrict__ valid,
    const int32_t* ln, int64_t g, int i0, int n, int32_t* sym) {
  int32_t bits = 0;
  if (i0 + GP_PER <= n
      && ((reinterpret_cast<uintptr_t>(codes + g)
           | reinterpret_cast<uintptr_t>(valid + g)) & 15) == 0) {
    const int4* c4 = reinterpret_cast<const int4*>(codes + g);
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(valid + g));
    const uint32_t fw[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int k = 0; k < GP_PER / 4; ++k) {
      const int4 v = __ldg(c4 + k);
      const int32_t cs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int code = clamp_code(cs[j]);
        const int32_t l = (fw[k] >> (8 * j)) & 0xffu ? ln[code] : 0;
        sym[4 * k + j] = code | (l << 16);
        bits += l;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < GP_PER; ++i) {
      int32_t l = 0, code = 0;
      if (i0 + i < n) {
        code = clamp_code(codes[g + i]);
        l = valid[g + i] ? ln[code] : 0;
      }
      sym[i] = code | (l << 16);
      bits += l;
    }
  }
  return bits;
}

// Packs the run's symbols into `buf` from tile bit `bit` on, composing
// whole words in a register: a codeword of len <= 32 bits at bit offset
// off of word w is the 64-bit v << (64 - off - len), whose high half
// goes to word w and low half to w + 1; `bits` is the run's bit count.
__device__ __forceinline__ void gp_compose(const int32_t* sym,
                                           const uint32_t* cw, int bit,
                                           int bits, uint32_t* buf) {
  const int b0 = bit, b1 = bit + bits;
  int cur = bit >> 5;
  uint32_t acc = 0, spill = 0;
#pragma unroll
  for (int i = 0; i < GP_PER; ++i) {
    const int len = sym[i] >> 16;
    const uint32_t v = cw[sym[i] & 0xffff];
    const int w = bit >> 5;
    const uint64_t x =
        len > 0 ? static_cast<uint64_t>(v) << (64 - (bit & 31) - len) : 0;
    bit += len;
    if (w != cur) {                 // w == cur + 1: word cur is whole
      gp_emit(buf, cur, acc, b0, b1);
      acc = spill;
      spill = 0;
      cur = w;
    }
    acc |= static_cast<uint32_t>(x >> 32);
    spill |= static_cast<uint32_t>(x);
  }
  gp_emit(buf, cur, acc, b0, b1);
  gp_emit(buf, cur + 1, spill, b0, b1);
}

// The exclusive prefix of a row's tile `tile`, by the whole CTA: each
// step reads the status words of the THREADS * GP_LOOK tiles before the
// last one read (GP_LOOK a thread, all in flight at once, each spun on
// until published) and adds their values from the nearest inclusive
// prefix on; part and has hold two steps' (sum, has a prefix) for each
// (word of the step, warp).
__device__ __forceinline__ int64_t gp_look_back(const unsigned long long* st,
                                                int64_t tile, int64_t* part,
                                                unsigned* has) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = THREADS / 32;
  int64_t excl = 0;
  for (int64_t j = tile - 1, step = 0; j >= 0;
       j -= THREADS * GP_LOOK, ++step) {
    unsigned long long s[GP_LOOK];
#pragma unroll
    for (int m = 0; m < GP_LOOK; ++m) {
      const int64_t idx = j - THREADS * m - tid;
      s[m] = idx >= 0 ? gp_status(st, idx) : ST_PRE;  // before the row: 0
    }
    int64_t* pt = part + (step & 1) * GP_LOOK * NW;
    unsigned* ht = has + (step & 1) * GP_LOOK * NW;
#pragma unroll
    for (int m = 0; m < GP_LOOK; ++m) {
      while ((s[m] >> 62) == 0) s[m] = gp_status(st, j - THREADS * m - tid);
      const unsigned p = __ballot_sync(0xffffffffu, (s[m] >> 62) == 2);
      const int stop = p ? __ffs(p) - 1 : 31;
      int64_t v = lane <= stop ? static_cast<int64_t>(s[m] & ST_VAL) : 0;
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) {
        pt[m * NW + warp] = v;
        ht[m * NW + warp] = p != 0;
      }
    }
    __syncthreads();
    bool found = false;
    for (int q = 0; q < GP_LOOK * NW && !found; ++q) {
      excl += pt[q];
      found = ht[q] != 0;
    }
    if (found) break;
  }
  return excl;
}

__global__ void __launch_bounds__(THREADS, GP_CTAS_PER_SM)
gather_pack_kernel(const int32_t* __restrict__ codes,
                   const uint8_t* __restrict__ valid,
                   const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ cwords, int64_t cv, int64_t bs,
                   int64_t nblocks, int64_t tiles, int64_t total_tiles,
                   int64_t w32, uint32_t* words, int32_t* block_nbits,
                   unsigned long long* status, unsigned long long* ticket) {
  __shared__ int32_t ln[NUM_SYMBOLS];
  __shared__ uint32_t cw[NUM_SYMBOLS];
  __shared__ __align__(16) uint32_t buf[GP_WORDS];
  __shared__ int32_t pre[THREADS + 1];    // the runs' tile-local first bits
  __shared__ int64_t s_next;
  __shared__ int64_t part[2 * GP_LOOK * (THREADS / 32)];
  __shared__ unsigned has[2 * GP_LOOK * (THREADS / 32)];
  const int tid = threadIdx.x;
  const int i0 = tid * GP_PER;
  if (tid == 0) s_next = static_cast<int64_t>(atomicAdd(ticket, 1ull));
  int64_t loaded = -1;                     // the row whose book is held
  for (;;) {
    __syncthreads();                       // the last tile is out
    const int64_t k = s_next;
    if (k >= total_tiles) break;
    const int64_t c = k / tiles, tile = k % tiles;
    unsigned long long next = 0;
    if (tid == 0) next = atomicAdd(ticket, 1ull);
    const int64_t t0 = tile * GP_TILE;     // row-relative
    const int n = static_cast<int>(min(static_cast<int64_t>(GP_TILE),
                                       cv - t0));
    if (c != loaded) {
      for (int s = tid; s < NUM_SYMBOLS; s += THREADS) {
        ln[s] = lengths[c * NUM_SYMBOLS + s];
        cw[s] = static_cast<uint32_t>(cwords[c * NUM_SYMBOLS + s]);
      }
      loaded = c;
    }
    for (int s = tid; s < GP_WORDS / 4; s += THREADS)
      reinterpret_cast<uint4*>(buf)[s] = make_uint4(0, 0, 0, 0);
    __syncthreads();                       // the book, the zeroed buffer

    int32_t sym[GP_PER];
    const int32_t mybits = gp_load_run(codes, valid, ln, c * cv + t0 + i0,
                                       i0, n, sym);
    int32_t total;
    const int32_t before = block_exclusive_scan(mybits, &total);
    pre[tid] = before;
    if (tid == 0) pre[THREADS] = total;
    unsigned long long* st = status + c * tiles;
    if (tid == 0)
      gp_publish(st + tile, (tile == 0 ? ST_PRE : ST_AGG)
                                | static_cast<unsigned long long>(total));
    gp_compose(sym, cw, before, mybits, buf);
    if (tid == 0) s_next = static_cast<int64_t>(next);
    __syncthreads();                       // the buffer, the runs' places
    const int64_t s0 = gp_look_back(st, tile, part, has);
    if (tid == 0 && tile > 0)
      gp_publish(st + tile,
                 ST_PRE | static_cast<unsigned long long>(s0 + total));

    // the stream blocks' bits: with bs a multiple of GP_PER each run lies
    // in one block, and a block's share of the tile is the difference of
    // the first bits of its first run and of the next block's (one
    // atomicAdd a (tile, block)); otherwise each run steps its block
    // boundaries
    int32_t* nb = block_nbits + c * nblocks;
    if (i0 < n) {
      const int64_t p0 = t0 + i0;
      if (bs % GP_PER == 0) {
        const int64_t blk = p0 / bs;
        if (i0 == 0 || p0 % bs == 0) {
          const int64_t end = min(static_cast<int64_t>(n),
                                  (blk + 1) * bs - t0);
          const int32_t v = pre[(end + GP_PER - 1) / GP_PER] - before;
          if (v) atomicAdd(nb + blk, v);
        }
      } else {
        int64_t blk = p0 / bs, nxt = (blk + 1) * bs;
        int32_t bb = 0;
#pragma unroll
        for (int i = 0; i < GP_PER; ++i) {
          if (p0 + i == nxt) {
            if (bb) atomicAdd(nb + blk, bb);
            ++blk;
            nxt += bs;
            bb = 0;
          }
          bb += sym[i] >> 16;
        }
        if (bb) atomicAdd(nb + blk, bb);
      }
    }
    if (total <= 0) continue;
    // out to the row at the tile's first bit, coalesced: a word wholly
    // inside the tile's bits is stored, the two edge words (shared with
    // the neighbouring tiles) are ORed; bits past w32 words are dropped
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

// Bytes of the pack's look-back scratch for C rows of cv symbols: one
// 64-bit status word a tile (C*tiles, tiles = ceil(cv / GP_TILE)), then
// the 64-bit ticket counter. The wrapper sizes its buffer with it.
extern "C" int64_t ceaz_gather_pack_scratch_bytes(int64_t C, int64_t cv) {
  return 8 * C * ((cv + GP_TILE - 1) / GP_TILE) + 8;
}

// The CTAs of one launch: as many as fit on the card at once, or fewer
// tiles.
static int64_t gather_pack_ctas(int64_t total_tiles) {
  static int64_t fit = 0;
  if (fit == 0) {
    int dev = 0, sms = 132, per = GP_CTAS_PER_SM;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per, gather_pack_kernel, THREADS, 0) != cudaSuccess
        || per < 1) {
      sms = 132;
      per = 1;
    }
    fit = static_cast<int64_t>(sms) * per;
  }
  return total_tiles < fit ? total_tiles : fit;
}

// The function of both TPU kernels, gather_pack_tiled and gather_pack, in
// one launch. words (C, w32), block_nbits (C, nblocks) and the 8-byte
// aligned scratch (its layout above) lie in one buffer of `bytes` bytes
// from `words` on, which this entry zeroes on the stream before the
// launch (the tiles' edge words and the blocks that span tiles are ORed
// and added into it; the words past a row's payload stay zero).
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
    gather_pack_kernel<<<static_cast<unsigned>(gather_pack_ctas(C * tiles)),
                         THREADS, 0, st>>>(
        static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(cwords), cv, bs, nblocks, tiles,
        C * tiles, w32, static_cast<uint32_t*>(words),
        static_cast<int32_t*>(block_nbits), status, status + C * tiles);
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
