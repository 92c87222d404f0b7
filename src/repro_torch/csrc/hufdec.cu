// Block-parallel canonical-Huffman table walks: one entry for two TPU
// kernels, and the packer of the decode tables it reads.
//
// ceaz_hufdec_tiles replaces two TPU kernels. First
// src/repro/kernels/megakernel/decode_kernel.py::hufdec_tiles (:246). It
// decodes chunks too large for the decode megakernel (more than 2^17
// values per row). Each (chunk, block) lane reads inside its tile's word
// window — tiles of 2^15/block_size blocks, the window placed where the
// tile's first block's bits start (clamped into the zero-padded row), as
// the TPU kernel's scalar-prefetched offsets place it — so the output
// matches the reference even on corrupted payloads. The kernel finds the
// lanes' first cursors and the windows itself: a CTA sums the bit counts
// of its row's blocks before its first one, a warp the rest (uint32, the
// reference's int32 cumsum wraps).
//
// Design (warp_walk.cuh): a CTA per SM takes tiles of up to 16
// consecutive blocks of one row by ticket, and holds the row's codebook
// in shared memory as 16-bit entries (128 KB), kept while the next tile
// has the same one; a warp stages its block's words in shared memory and
// decodes the block by 64 self-synchronising segments, two a lane, into
// its shared staging row, whence the codes leave in coalesced stores. A
// block that the exact acceptance rule does not admit (corrupted bits,
// garbage bit counts) is walked by walk_lane in the same kernel, against
// the 32-bit table. Bound on the H100: bytes (4 B a value out). What
// holds it back (measured with clock64 in a scratch build, phase A):
// ~100-cycle dependent steps, two or three passes of block_size/64 steps
// a lane, six warps an SM (the table and the staging rows fill shared
// memory), and the table load, which 132 SMs share the L2's bandwidth
// for.
//
// The same entry replaces the TPU kernel src/repro/kernels/hufdec/
// kernel.py::hufdec (:85), the walk of the split decode route, whose lanes
// each walk inside their chunk's whole row: the wrapper (hufdec/ops.py::
// row_geometry) gives it one window of the whole row (win = W) in tiles
// of one block, so every window starts at word 0 (span = W - win = 0),
// and a lane's cursor is its row-relative first bit, the exclusive
// uint32 prefix of its row's block bit counts — the arguments the
// split route's one-thread-a-lane walk handed walk_lane, which this
// design replaced. The grid is persistent, so any row count.
//
// ceaz_pack_tables packs a stack of decode tables once a call: the
// 32-bit (len << 16) | sym entries walk_lane reads and the 16-bit
// (len << 10) | sym entries of the warp walk, and raises a host-visible
// flag when an entry has sym outside [0, 1024) or len outside [0, 16].
#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"
#include "warp_walk.cuh"

namespace {

__global__ void ceaz_table_pack_kernel(const int32_t* __restrict__ sym,
                                       const int32_t* __restrict__ len,
                                       int64_t n, int32_t* t32, uint16_t* t16,
                                       int* flag) {
  bool bad = false;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint32_t s = static_cast<uint32_t>(sym[i]);
    const uint32_t l = static_cast<uint32_t>(len[i]);
    const bool ok = s <= ceaz::WW_SYM_MASK
                    && l <= static_cast<uint32_t>(ceaz::MAX_CODE_BITS);
    t32[i] = static_cast<int32_t>((l << 16) | s);
    t16[i] = ok ? static_cast<uint16_t>((l << ceaz::WW_SYM_BITS) | s) : 0;
    bad |= !ok;
  }
  if (bad) *flag = 1;
}

__global__ void __launch_bounds__(ceaz::WW_MAX_WARPS * 32, 1)
ceaz_tiles_walk_kernel(const uint32_t* __restrict__ words, int64_t W,
                       const int32_t* __restrict__ nbits,
                       const int32_t* __restrict__ counts,
                       const int32_t* __restrict__ table32,
                       const uint16_t* __restrict__ table16,
                       const int32_t* __restrict__ cb_idx, int64_t NB,
                       int64_t bs, int64_t tb, int64_t win, int64_t groups,
                       int64_t tiles, int64_t area, int32_t* out,
                       int32_t* stats, int32_t* ticket) {
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
  for (int64_t t; (t = ceaz::ww_next_tile(ticket, tiles, &s_tile)) >= 0;) {
    const int64_t c = t / groups;
    const int64_t b0 = (t % groups) * (blockDim.x >> 5);
    const int64_t b = b0 + warp;
    const int64_t cb = cb_idx[c];
    if (cb != loaded) {
      ceaz::ww_load_table(tbl, table16 + cb * ceaz::TBL);
      loaded = cb;
    }
    const int32_t* nb = nbits + c * NB;
    const uint32_t base = ceaz::ww_row_prefix(nb, b0, part);
    const uint32_t* row = words + c * W;
    int64_t foff = 0;
    int32_t rel = 0, cnt = 0;
    bool adm = false;
    if (b < NB) {
      // this block's first bit, and its tile's window
      uint32_t own = 0;
      for (int k = lane; k < warp; k += 32)
        own += static_cast<uint32_t>(nb[b0 + k]);
      const uint32_t excl = base + ceaz::ww_sum(own);
      uint32_t sub = 0;
      for (int64_t k = b / tb * tb + lane; k < b; k += 32)
        sub += static_cast<uint32_t>(nb[k]);
      const int32_t g0 = static_cast<int32_t>(excl - ceaz::ww_sum(sub));
      const int64_t span = (W > win ? W : win) - win;
      foff = g0 >> 5;
      foff = foff < 0 ? 0 : (foff > span ? span : foff);
      rel = static_cast<int32_t>(excl - static_cast<uint32_t>(foff * 32));
      const int64_t cnt64 = static_cast<int64_t>(counts[c]) - b * bs;
      cnt = static_cast<int32_t>(cnt64 < 0 ? 0 : (cnt64 > bs ? bs : cnt64));
      adm = ceaz::ww_begin(row, W, foff, win, rel, nb[b], cnt, bs, stage);
    }
    ceaz::ww_cp_wait();                // the table and the payloads
    __syncthreads();
    if (b < NB) {
      int32_t* ob = out + (c * NB + b) * bs;
      uint32_t ssum;
      int32_t nz;
      if (cnt == 0)
        ceaz::ww_zero(bs, ob);
      else if (ceaz::ww_block(row, W, foff, win, rel, nb[b], cnt, bs, adm,
                              tbl, table32 + cb * ceaz::TBL, stage, ob, &ssum,
                              &nz, s_stats))
        ceaz::ww_store_codes(stage, cnt, bs, ob);
    }
  }
  ceaz::ww_flush_stats(s_stats, stats);
}

}  // namespace

// sym/len: n int32 entries (K stacked 2^16-entry tables); t32 (n,) int32,
// t16 (n,) uint16; flag a zeroed int in pinned host memory (read by the
// host once the packer is done), set to 1 on an entry out of range.
extern "C" int ceaz_pack_tables(const void* sym, const void* len, int64_t n,
                                void* t32, void* t16, void* flag,
                                void* stream) {
  if (n > 0) {
    int64_t blocks = (n + 255) / 256;
    blocks = blocks < 132 * 8 ? blocks : 132 * 8;
    ceaz_table_pack_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(sym), static_cast<const int32_t*>(len), n,
        static_cast<int32_t*>(t32), static_cast<uint16_t*>(t16),
        static_cast<int*>(flag));
  }
  return static_cast<int>(cudaGetLastError());
}

// nbits (C, NB), counts/cb_idx (C,) int32; tables as ceaz_pack_tables
// writes them; tb blocks a tile and win words a window (the wrapper's
// tile_geometry); out (C, NB*bs) int32, fully written; stats
// (WW_STATS,) int32, added to; ticket one int32, zeroed here on the
// stream.
extern "C" int ceaz_hufdec_tiles(const void* words, int64_t C, int64_t W,
                                 const void* nbits, const void* counts,
                                 const void* table32, const void* table16,
                                 const void* cb_idx, int64_t NB, int64_t bs,
                                 int64_t tb, int64_t win, void* out,
                                 void* stats, void* ticket, void* stream) {
  if (C > 0 && NB > 0) {
    const ceaz::WWConfig cfg = ceaz::ww_config(bs);
    const int64_t groups = (NB + cfg.warps - 1) / cfg.warps;
    const int64_t tiles = C * groups;
    if (bs <= 0 || tb <= 0 || win < 2 || tiles >= INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(ceaz_tiles_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cfg.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ceaz_tiles_walk_kernel<<<static_cast<unsigned>(ceaz::ww_ctas(tiles)),
                             cfg.warps * 32, cfg.smem, st>>>(
        static_cast<const uint32_t*>(words), W,
        static_cast<const int32_t*>(nbits), static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(table32),
        static_cast<const uint16_t*>(table16),
        static_cast<const int32_t*>(cb_idx), NB, bs, tb, win, groups, tiles,
        cfg.area, static_cast<int32_t*>(out), static_cast<int32_t*>(stats),
        static_cast<int32_t*>(ticket));
  }
  return static_cast<int>(cudaGetLastError());
}
