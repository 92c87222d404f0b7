// Shared dual-quantization arithmetic: every quantizing kernel of the
// port (dualquant.cu, bank.cu) rounds through these functions, so one
// f32 value prequantizes to the same integer whichever kernel reads it.
//
// prequant matches the reference's compiled f32 ops step by step
// (src/repro/core/dualquant.py::prequantize): q = rint(x / 2eb) with a
// correctly rounded divide, clip to +-2e9, err = x - q*2eb rounded once
// (XLA contracts the mul-sub into an FMA), the +-1 nudge in f32, then
// the int cast with NaN sent to 0 (XLA's conversion). The build passes
// -fmad=false and the _rn intrinsics pin every other rounding.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace ceaz {

constexpr int RADIUS = 512;
constexpr int NUM_SYMBOLS = 1024;

__device__ __forceinline__ float two_eb_of(float eb) {
  return __fmul_rn(eb, 2.0f);
}

__device__ __forceinline__ int32_t prequant(float x, float eb, float two_eb) {
  float q = rintf(__fdiv_rn(x, two_eb));
  if (!isnan(q)) q = fminf(fmaxf(q, -2.0e9f), 2.0e9f);
  // x - q*2eb with ONE rounding: the reference's XLA build contracts
  // this mul-sub into an FMA, so the nudge below must see the FMA's err
  float err = __fmaf_rn(-q, two_eb, x);
  q = __fadd_rn(q, err > eb ? 1.0f : 0.0f);
  q = __fsub_rn(q, err < -eb ? 1.0f : 0.0f);
  if (isnan(q)) return 0;
  return static_cast<int32_t>(q);  // integral and within +-(2e9 + 1)
}

// delta = q - pred wrapped to int32; its code is delta + RADIUS, and
// code 0 escapes every delta outside [-RADIUS+1, RADIUS-1].
struct Post {
  int32_t delta;
  int32_t code;  // 0 for an outlier
  bool outlier;
};

__device__ __forceinline__ Post postquant(int32_t q, int32_t pred) {
  Post p;
  p.delta = static_cast<int32_t>(static_cast<uint32_t>(q) -
                                 static_cast<uint32_t>(pred));
  int64_t code = static_cast<int64_t>(p.delta) + RADIUS;
  p.outlier = code < 1 || code >= NUM_SYMBOLS;
  p.code = p.outlier ? 0 : static_cast<int32_t>(code);
  return p;
}

}  // namespace ceaz
