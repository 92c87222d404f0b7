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
//   gather_pack: one CTA per chunk row walks the row in tiles of 4096
//     symbols and carries the running bit offset from tile to tile, so the
//     prefix sum never leaves the CTA and the pack is one launch; the
//     per-block counts are integer atomicAdds of each run's share.
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

constexpr int GP_PER = 16;                        // symbols a thread per tile
constexpr int64_t GP_TILE = THREADS * GP_PER;     // 4096 symbols a tile

__global__ void gather_pack_kernel(const int32_t* __restrict__ codes,
                                   const uint8_t* __restrict__ valid,
                                   const int32_t* __restrict__ lengths,
                                   const int32_t* __restrict__ cwords,
                                   int64_t cv, int64_t bs, int64_t nblocks,
                                   int64_t w32, uint32_t* words,
                                   int32_t* block_nbits) {
  __shared__ int32_t ln[NUM_SYMBOLS];
  __shared__ uint32_t cw[NUM_SYMBOLS];
  int64_t c = blockIdx.x;
  load_tables(lengths + c * NUM_SYMBOLS, cwords + c * NUM_SYMBOLS, ln, cw);
  const int32_t* crow = codes + c * cv;
  const uint8_t* vrow = valid + c * cv;
  int32_t* nb = block_nbits + c * nblocks;
  int64_t base = 0;                     // the row's bit offset at this tile
  for (int64_t t0 = 0; t0 < cv; t0 += GP_TILE) {
    int64_t p0 = min(t0 + static_cast<int64_t>(threadIdx.x) * GP_PER, cv);
    int64_t p1 = min(p0 + GP_PER, cv);
    // the run's bits, and its share of each stream block it touches
    int32_t mybits = 0, blk_bits = 0;
    int64_t blk = p0 / bs;
    for (int64_t p = p0; p < p1; ++p) {
      if (p / bs != blk) {
        if (blk_bits) atomicAdd(nb + blk, blk_bits);
        blk = p / bs;
        blk_bits = 0;
      }
      if (vrow[p]) {
        int32_t l = ln[clamp_code(crow[p])];
        blk_bits += l;
        mybits += l;
      }
    }
    if (blk_bits) atomicAdd(nb + blk, blk_bits);
    int32_t total;
    int32_t before = block_exclusive_scan(mybits, &total);
    pack_run(crow, vrow, p0, p1, ln, cw, base + before, words + c * w32, w32);
    base += total;
    __syncthreads();                    // the next tile's scan reuses smem
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

// words (C, w32) and block_nbits (C, nblocks) must be zeroed by the caller.
extern "C" int ceaz_gather_pack(const void* codes, const void* valid,
                                const void* lengths, const void* cwords,
                                int64_t C, int64_t cv, int64_t bs,
                                int64_t nblocks, int64_t w32, void* words,
                                void* block_nbits, void* stream) {
  if (C > 0 && cv > 0) {
    gather_pack_kernel<<<static_cast<unsigned>(C), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(lengths),
        static_cast<const int32_t*>(cwords), cv, bs, nblocks, w32,
        static_cast<uint32_t*>(words), static_cast<int32_t*>(block_nbits));
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
