// The canonical-Huffman table walk of one (chunk, block) lane, shared by
// the walk kernel (hufdec.cu) and the decode megakernel
// (decode_fused.cu).
//
// Arithmetic of the reference's _walk_window
// (src/repro/kernels/megakernel/decode_kernel.py:61-73): each step peeks
// a 16-bit MSB-first window at the cursor from two u32 words, looks the
// window up in the chunk's decode table, and advances by the code
// length. The cursor is clamped into the lane's word window
// [foff, foff + win) before every peek, and words past the row read as
// zero, so corrupted bits can decode to nonsense but can neither hang
// the walk (it runs exactly min(count, block_size) steps) nor read out
// of bounds. On valid streams the clamp never binds.
//
// The decode table is packed: entry = (code length << 16) | symbol, one
// 32-bit load per step instead of two.
#pragma once
#include <stdint.h>

namespace ceaz {

constexpr int MAX_CODE_BITS = 16;
constexpr int TBL = 1 << MAX_CODE_BITS;

// Walks `cnt` symbols of one lane, writing out[0, bs): symbols for
// i < cnt, zeros past it. Returns how many decoded symbols were code 0
// (the dual-quantizer's outlier escape).
__device__ __forceinline__ int32_t walk_lane(
    const uint32_t* __restrict__ row, int64_t W, int64_t foff, int64_t win,
    int64_t cursor, const int32_t* __restrict__ table, int32_t cnt,
    int32_t bs, int32_t* out) {
  int64_t cmax = (win - 2) * 32 + 31;
  int32_t zeros = 0;
  for (int32_t i = 0; i < bs; ++i) {
    if (i >= cnt) {
      out[i] = 0;
      continue;
    }
    int64_t cur = cursor < 0 ? 0 : (cursor > cmax ? cmax : cursor);
    int64_t w = foff + (cur >> 5);
    uint32_t b = static_cast<uint32_t>(cur & 31);
    uint32_t x0 = w < W ? __ldg(row + w) : 0u;
    uint32_t x1 = w + 1 < W ? __ldg(row + w + 1) : 0u;
    uint32_t window = (x0 << b) | (b > 0 ? x1 >> (32u - b) : 0u);
    int32_t e = __ldg(table + (window >> (32 - MAX_CODE_BITS)));
    int32_t sym = e & 0xFFFF;
    out[i] = sym;
    zeros += sym == 0;
    cursor += e >> 16;
  }
  return zeros;
}

}  // namespace ceaz
