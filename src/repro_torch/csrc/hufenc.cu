// Huffman packers: codebook gather + contiguous MSB-first bit packing
// into u32 words, plus per-block bit counts.
//
// Replaces three TPU kernels of src/repro/kernels/hufenc/kernel.py:
//
//   * gather_pack_tiled (:267; block sums at :290, pack at :333), the
//     fused route's pass 2, and gather_pack (:164; pallas_call at :178),
//     the same function with one program per chunk: both are
//     gather_pack_kernel, one launch (the wrappers count it under the
//     TPU kernel each replaces);
//   * hufenc (:344; pallas_call at :353), the serial per-block packer of
//     one flat stream against one book, followed by the reference's host
//     concatenation of the blocks' padded rows (hufenc/ops.py::
//     to_host_stream): hufenc_kernel writes the concatenated stream
//     directly, one launch.
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
//   hufenc_kernel: the same tiles, look-back and per-tile count, compose
//     and write-out over one flat row with one book and no valid flags;
//     each CTA's next tile is prefetched into the L2 by a TMA bulk
//     prefetch while it packs the current one (below, before the kernel).
//
// Bound on the H100: bytes — each value is read once as a 4 B code (and,
// in gather_pack_kernel, a 1 B valid flag), and the payload (~2-16 bits
// a value) is written once; the codebook rows (8 KB per book) sit in
// shared memory.
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

// A tile's status word. The word carries flag and value in one 64-bit
// store, and a reader uses nothing else the writer wrote, so no fence is
// needed for the look-back itself; gather_pack_kernel keeps the fence it
// was measured with (kFence).
template <bool kFence = true>
__device__ __forceinline__ void gp_publish(unsigned long long* st,
                                           unsigned long long v) {
  if (kFence) __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(st) = v;
}

// Tile i's status word, read past the caches.
__device__ __forceinline__ unsigned long long gp_status(
    const unsigned long long* st, int64_t i) {
  return *reinterpret_cast<const volatile unsigned long long*>(st + i);
}

// A composed word of a run into the tile's buffer: stored when it lies
// wholly inside the run's bits [b0, b1) (no other thread has bits there;
// stored even when zero, so the buffer's interior words need no zeroing),
// ORed when it is shared with a neighbouring run (an edge word of the
// run, zeroed before: gp_zero_edges).
__device__ __forceinline__ void gp_emit(uint32_t* buf, int w, uint32_t acc,
                                        int b0, int b1) {
  if (w < 0 || w >= GP_WORDS) return;
  if (32 * w >= b0 && 32 * w + 32 <= b1)
    buf[w] = acc;
  else if (acc != 0)
    atomicOr(buf + w, acc);
}

// Zeroes the two edge words of a run's bits [b0, b1) in the tile's
// buffer: the only words of the run that gp_emit ORs. A word wholly
// inside another run holds none of this run's bits, so no store of
// another thread lands here; the CTA syncs between this and gp_compose.
__device__ __forceinline__ void gp_zero_edges(uint32_t* buf, int b0,
                                              int b1) {
  if (b1 <= b0) return;
  buf[b0 >> 5] = 0u;
  buf[(b1 - 1) >> 5] = 0u;
}

// The run's symbols from the row into sym[] (the clamped code), with
// each symbol's length in the high half (0 when invalid or past the
// tile's n symbols) -> the run's bits. g: the run's first symbol's global
// index; i0: its index in the tile. Without flags (kValid false) every
// symbol before n is valid and `valid` is not read.
template <bool kValid = true>
__device__ __forceinline__ int32_t gp_load_run(
    const int32_t* __restrict__ codes, const uint8_t* __restrict__ valid,
    const int32_t* ln, int64_t g, int i0, int n, int32_t* sym) {
  int32_t bits = 0;
  if (i0 + GP_PER <= n
      && ((reinterpret_cast<uintptr_t>(codes + g)
           | (kValid ? reinterpret_cast<uintptr_t>(valid + g) : 0)) & 15)
             == 0) {
    const int4* c4 = reinterpret_cast<const int4*>(codes + g);
    uint32_t fw[4] = {~0u, ~0u, ~0u, ~0u};
    if (kValid) {
      const uint4 f = __ldg(reinterpret_cast<const uint4*>(valid + g));
      fw[0] = f.x;
      fw[1] = f.y;
      fw[2] = f.z;
      fw[3] = f.w;
    }
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
        l = !kValid || valid[g + i] ? ln[code] : 0;
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

// A tile's bits into its stream blocks (block_nbits row nb), from the
// runs' scanned first bits: with bs a multiple of GP_PER each run lies in
// one block, and a block's share of the tile is the difference of the
// first bits of its first run and of the next block's (pre[]: the runs'
// tile-local first bits, pre[THREADS] the tile's total; one atomicAdd a
// (tile, block), whatever bs, also past a tile); otherwise each run steps
// its block boundaries. t0: the tile's first symbol in the row; i0: the
// run's in the tile; n: the tile's symbols.
__device__ __forceinline__ void gp_block_bits(const int32_t* pre,
                                              const int32_t* sym, int64_t t0,
                                              int i0, int n, int32_t before,
                                              int64_t bs, int32_t* nb) {
  if (i0 >= n) return;
  const int64_t p0 = t0 + i0;
  if (bs % GP_PER == 0) {
    const int64_t blk = p0 / bs;
    if (i0 == 0 || p0 % bs == 0) {
      const int64_t end = min(static_cast<int64_t>(n), (blk + 1) * bs - t0);
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

// The tile's buffer (total bits from its bit 0) out to the row at the
// tile's first bit s0, coalesced: a word wholly inside the tile's bits is
// stored, the two edge words (shared with the neighbouring tiles) are
// ORed into the zeroed row; bits past w32 words are dropped.
__device__ __forceinline__ void gp_write_out(const uint32_t* buf, int64_t s0,
                                             int32_t total, uint32_t* row,
                                             int64_t w32) {
  if (total <= 0) return;
  const int o = static_cast<int>(s0 & 31);
  const int64_t w0 = s0 >> 5;
  const int nbuf = (total + 31) >> 5;
  const int nout = (o + total + 31) >> 5;
  for (int j = threadIdx.x; j < nout && w0 + j < w32; j += THREADS) {
    const uint32_t hi = j < nbuf ? buf[j] : 0u;
    uint32_t v = hi;
    if (o != 0) v = (hi >> o) | (j > 0 ? buf[j - 1] << (32 - o) : 0u);
    if (32 * j >= o && 32 * (j + 1) <= o + total)
      row[w0 + j] = v;
    else if (v != 0)
      atomicOr(row + w0 + j, v);
  }
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
    gp_block_bits(pre, sym, t0, i0, n, before, bs, block_nbits + c * nblocks);
    gp_write_out(buf, s0, total, words + c * w32, w32);
  }
}

// ---- hufenc: one flat stream against one book, one launch --------------
//
// The reference packs each 4096-symbol stream block into its own padded
// row and the host lays the rows end to end (to_host_stream); the
// port's first design did the same on the card (a row buffer zeroed,
// a CTA a block into its row, a cumsum, a stitch kernel ORing every row
// word into the stream: the payload crossed memory three times). Here
// the stream is packed where it lies, by gather_pack_kernel's scheme for
// one row: persistent CTAs take its 4096-symbol tiles by ticket, in one
// ticket order, a CTA holding at most one ticket beyond the tile it
// packs; each thread loads its run of GP_PER symbols into registers by
// 16-byte loads (gp_load_run) and sums its bits, a block-wide scan places
// the runs, the tile publishes its aggregate, composes its words into a
// shared buffer, looks back for its first bit (int64 prefixes, 64-bit
// status words) and writes the buffer out shifted to it, storing interior
// words and ORing only its two edge words; the blocks' bit counts come
// from the runs' scanned first bits (gp_block_bits), for any block size.
// What differs, by design and as measured on the H100 (PERF.md section 6):
//   * one book for the stream: a CTA loads it into shared memory once;
//   * no valid flags: 4 B a value is read, and past n there is nothing;
//   * the next tile's codes are prefetched into the L2 by one TMA bulk
//     prefetch (cp.async.bulk.prefetch.L2, issued by one thread as soon
//     as the next ticket is back), so its loads hit the L2 while the
//     memory streams the tile after: the CTAs of an SM move through
//     their tiles nearly in step (gather_pack_kernel's wall), and this
//     keeps the memory busy while they pack and look back, at no cost in
//     registers or issue slots to the packing threads. Staging the codes
//     in shared memory by TMA bulk copy instead (a ring of two stages, by
//     the CTA or by a producer warp) measured slower;
//   * the buffer's interior words are stored and each thread zeroes its
//     run's two edge words before the ORs (gp_zero_edges), so nothing
//     else in it is zeroed;
//   * status words are published without a fence (gp_publish).
// A CTA waits only on tiles of lower tickets, each held by a running CTA
// that works through its tickets in order, so the grid needs no
// co-residency guarantee.
__global__ void __launch_bounds__(THREADS, GP_CTAS_PER_SM)
hufenc_kernel(const int32_t* __restrict__ codes, int64_t n,
              const int32_t* __restrict__ lengths,
              const int32_t* __restrict__ cwords, int64_t bs, int64_t tiles,
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
  for (int s = tid; s < NUM_SYMBOLS; s += THREADS) {
    ln[s] = lengths[s];
    cw[s] = static_cast<uint32_t>(cwords[s]);
  }
  for (;;) {
    __syncthreads();                       // the book; the last tile is out
    const int64_t tile = s_next;
    if (tile >= tiles) break;
    unsigned long long next = 0;
    if (tid == 0) next = atomicAdd(ticket, 1ull);
    const int64_t t0 = tile * GP_TILE;
    const int nt = static_cast<int>(min(static_cast<int64_t>(GP_TILE),
                                        n - t0));
    int32_t sym[GP_PER];
    const int32_t mybits = gp_load_run<false>(codes, nullptr, ln, t0 + i0,
                                              i0, nt, sym);
    int32_t total;
    const int32_t before = block_exclusive_scan(mybits, &total);
    pre[tid] = before;
    if (tid == 0) {
      pre[THREADS] = total;
      gp_publish<false>(status + tile,
                        (tile == 0 ? ST_PRE : ST_AGG)
                            | static_cast<unsigned long long>(total));
      // the next tile into the L2: its codes from their first 16-byte
      // boundary to their last, in one bulk prefetch
      const int64_t n0 = static_cast<int64_t>(next) * GP_TILE;
      if (n0 < n) {
        const uintptr_t p0 = (reinterpret_cast<uintptr_t>(codes + n0) + 15)
                             & ~uintptr_t(15);
        const uintptr_t p1 = reinterpret_cast<uintptr_t>(
                                 codes + min(n, n0 + GP_TILE)) & ~uintptr_t(15);
        if (p1 > p0)
          asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                       :: "l"(p0), "r"(static_cast<uint32_t>(p1 - p0))
                       : "memory");
      }
    }
    gp_zero_edges(buf, before, before + mybits);
    __syncthreads();
    gp_compose(sym, cw, before, mybits, buf);
    if (tid == 0) s_next = static_cast<int64_t>(next);
    __syncthreads();                       // the buffer, the runs' places
    const int64_t s0 = gp_look_back(status, tile, part, has);
    if (tid == 0 && tile > 0)
      gp_publish<false>(status + tile,
                        ST_PRE | static_cast<unsigned long long>(s0 + total));
    gp_block_bits(pre, sym, t0, i0, nt, before, bs, block_nbits);
    gp_write_out(buf, s0, total, words, w32);
  }
}

}  // namespace

// Bytes of the pack's look-back scratch for C rows of cv symbols: one
// 64-bit status word a tile (C*tiles, tiles = ceil(cv / GP_TILE)), then
// the 64-bit ticket counter. The wrappers size their buffers with it
// (hufenc_kernel's with C = 1).
extern "C" int64_t ceaz_gather_pack_scratch_bytes(int64_t C, int64_t cv) {
  return 8 * C * ((cv + GP_TILE - 1) / GP_TILE) + 8;
}

// The CTAs of one launch of `kernel`: as many as fit on the card at once
// (counted once, into *fit), or fewer tiles.
template <typename Kernel>
static int64_t resident_ctas(Kernel kernel, int64_t* fit, int64_t tiles) {
  if (*fit == 0) {
    int dev = 0, sms = 132, per = GP_CTAS_PER_SM;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                         THREADS, 0)
               != cudaSuccess
        || per < 1) {
      sms = 132;
      per = 1;
    }
    *fit = static_cast<int64_t>(sms) * per;
  }
  return tiles < *fit ? tiles : *fit;
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
  static int64_t fit = 0;
  if (C > 0 && cv > 0) {
    const int64_t tiles = (cv + GP_TILE - 1) / GP_TILE;
    if (bs <= 0 || C * tiles > INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(words, 0, bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto* status = static_cast<unsigned long long*>(scratch);
    gather_pack_kernel<<<static_cast<unsigned>(
                             resident_ctas(gather_pack_kernel, &fit,
                                           C * tiles)),
                         THREADS, 0, st>>>(
        static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(cwords), cv, bs, nblocks, tiles,
        C * tiles, w32, static_cast<uint32_t*>(words),
        static_cast<int32_t*>(block_nbits), status, status + C * tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// The TPU kernel hufenc with the host's concatenation of its rows: the n
// codes of one stream against one book (lengths, cwords (1024,)) packed
// into the host stream's w32 u32 words, and block_nbits (nblocks,) the
// bits of each block of bs symbols (the tail block's real symbols only).
// words, block_nbits and the scratch (ceaz_gather_pack_scratch_bytes(1,
// n)) lie in one buffer of `bytes` bytes from `words` on, zeroed here on
// the stream before the launch, as ceaz_gather_pack's.
extern "C" int ceaz_hufenc(const void* codes, int64_t n, const void* lengths,
                           const void* cwords, int64_t bs, int64_t w32,
                           void* words, void* block_nbits, void* scratch,
                           int64_t bytes, void* stream) {
  static int64_t fit = 0;
  if (n > 0) {
    const int64_t tiles = (n + GP_TILE - 1) / GP_TILE;
    if (bs <= 0 || tiles > INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(words, 0, bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto* status = static_cast<unsigned long long*>(scratch);
    hufenc_kernel<<<static_cast<unsigned>(
                        resident_ctas(hufenc_kernel, &fit, tiles)),
                    THREADS, 0, st>>>(
        static_cast<const int32_t*>(codes), n,
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(cwords), bs, tiles, w32,
        static_cast<uint32_t*>(words), static_cast<int32_t*>(block_nbits),
        status, status + tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
