// Dual-quantization pass 1: prequantize -> Lorenzo predict -> postquantize.
//
// Replaces the TPU kernels src/repro/kernels/dualquant/kernel.py::dq1d
// (:101) and ::dq2d (:131). Differences from them:
//   * dq1d here is the GLOBAL 1-D Lorenzo of a flat array (one row), the
//     prediction the reference's whole-array pass 1 uses; the TPU kernel
//     resets per row for its streaming layout;
//   * ragged edges are masked here; the TPU kernels need rows % 8 == 0
//     and cols % 512 == 0;
//   * a fourth output, q (the prequantized field), saves the reference's
//     inverse-Lorenzo cumsum in pass 1: delta telescopes back to q under
//     int32 wrap, so q is the field the literal check replays.
//
// Bound on the H100: bytes. Per value it reads 4 B of x and writes
// codes (4 B), outlier (1 B), delta (4 B) and q (4 B): 17 B/value against
// ~30 f32 operations, far under the card's 20 ops/byte balance point.
// Design: one thread per value, which recomputes its W/N/NW neighbours'
// q from x instead of exchanging them (the neighbours' x is in L1/L2 from
// the adjacent threads' own loads), so there is no shared-memory staging
// and no halo bookkeeping; stores are coalesced.
//
// Rounding goes through quant.cuh's prequant, shared with every other
// quantizing kernel of the port.
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

using ceaz::prequant;

__device__ __forceinline__ void postquant(int64_t i, int32_t q, uint32_t pred,
                                          int32_t* codes, uint8_t* outl,
                                          int32_t* delta, int32_t* qout) {
  ceaz::Post p = ceaz::postquant(q, static_cast<int32_t>(pred));
  codes[i] = p.code;
  outl[i] = p.outlier ? 1 : 0;
  delta[i] = p.delta;
  qout[i] = q;
}

__device__ __forceinline__ void zero_pad(int64_t i, int32_t* codes,
                                         uint8_t* outl, int32_t* delta) {
  codes[i] = 0;
  outl[i] = 0;
  delta[i] = 0;
}

__global__ void dq1d_kernel(const float* __restrict__ x, int64_t n,
                            int64_t n_out, float eb, int32_t* codes,
                            uint8_t* outl, int32_t* delta, int32_t* qout) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  if (i >= n) {
    zero_pad(i, codes, outl, delta);
    return;
  }
  float two_eb = __fmul_rn(eb, 2.0f);
  int32_t q = prequant(x[i], eb, two_eb);
  uint32_t pred = i > 0 ? static_cast<uint32_t>(prequant(x[i - 1], eb, two_eb))
                        : 0u;
  postquant(i, q, pred, codes, outl, delta, qout);
}

__global__ void dq2d_kernel(const float* __restrict__ x, int64_t rows,
                            int64_t cols, int64_t n_out, float eb,
                            int32_t* codes, uint8_t* outl, int32_t* delta,
                            int32_t* qout) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t n = rows * cols;
  if (i >= n_out) return;
  if (i >= n) {
    zero_pad(i, codes, outl, delta);
    return;
  }
  int64_t r = i / cols;
  int64_t c = i - r * cols;
  float two_eb = __fmul_rn(eb, 2.0f);
  int32_t q = prequant(x[i], eb, two_eb);
  uint32_t w = c > 0 ? static_cast<uint32_t>(prequant(x[i - 1], eb, two_eb)) : 0u;
  uint32_t nn = r > 0 ? static_cast<uint32_t>(prequant(x[i - cols], eb, two_eb))
                      : 0u;
  uint32_t nw = (r > 0 && c > 0)
                    ? static_cast<uint32_t>(prequant(x[i - cols - 1], eb, two_eb))
                    : 0u;
  postquant(i, q, w + nn - nw, codes, outl, delta, qout);
}

constexpr int THREADS = 256;

inline unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int ceaz_dq1d(const void* x, int64_t n, int64_t n_out, float eb,
                         void* codes, void* outl, void* delta, void* q,
                         void* stream) {
  if (n_out > 0) {
    dq1d_kernel<<<grid_for(n_out), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, n_out, eb,
        static_cast<int32_t*>(codes), static_cast<uint8_t*>(outl),
        static_cast<int32_t*>(delta), static_cast<int32_t*>(q));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ceaz_dq2d(const void* x, int64_t rows, int64_t cols,
                         int64_t n_out, float eb, void* codes, void* outl,
                         void* delta, void* q, void* stream) {
  if (n_out > 0) {
    dq2d_kernel<<<grid_for(n_out), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), rows, cols, n_out, eb,
        static_cast<int32_t*>(codes), static_cast<uint8_t*>(outl),
        static_cast<int32_t*>(delta), static_cast<int32_t*>(q));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ceaz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
