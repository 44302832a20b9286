// torch's float32 arithmetic on the card, operation for operation, for the
// kernels that are held bit-equal to torch code (photon.cu, wave_inputs.cu):
// every product, sum and quotient rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: never contracted into an FMA) except where torch's
// kernel contracts it (the cross product), and a sum over the three
// components of a vector in torch's reduction order.
#pragma once

#include <cuda_runtime.h>

namespace {

struct F3 {
  float x, y, z;
};

__device__ __forceinline__ F3 f3(float x, float y, float z) {
  F3 r;
  r.x = x; r.y = y; r.z = z;
  return r;
}
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
// Python's 1.0 / x on a tensor: x.reciprocal() * 1.0
__device__ __forceinline__ float rcp(float x) { return __fdiv_rn(1.0f, x); }
// torch.clamp(x, min=lo) and clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ F3 add3(F3 a, F3 b) {
  return f3(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z));
}
__device__ __forceinline__ F3 sub3(F3 a, F3 b) {
  return f3(sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z));
}
__device__ __forceinline__ F3 mul3(F3 a, F3 b) {
  return f3(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z));
}
__device__ __forceinline__ F3 scale3(float s, F3 a) {
  return f3(mul(s, a.x), mul(s, a.y), mul(s, a.z));
}
// torch.sum over the last axis of a contiguous (R, 3) tensor on the card:
// two threads of a reduction row, the first adding components 0 and 2
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return add(add(a0, a2), a1);
}
__device__ __forceinline__ float dot3(F3 a, F3 b) {
  return sum3(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z));
}
// torch.linalg.cross on the card: each component a * b - c * d with the
// first product contracted into an FMA
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -mul(c, d));
}
__device__ __forceinline__ F3 cross3(F3 a, F3 b) {
  return f3(cross1(a.y, b.z, a.z, b.y), cross1(a.z, b.x, a.x, b.z),
            cross1(a.x, b.y, a.y, b.x));
}

// ---- render/geom.py --------------------------------------------------------
// normalize(v): v / clamp(vector_norm(v), min=1e-300), the norm summed as
// torch.sum sums (1e-300 is 0 in float32)
__device__ __forceinline__ F3 normalize3(F3 v) {
  const float n = clamp_min(
      __fsqrt_rn(sum3(mul(v.x, v.x), mul(v.y, v.y), mul(v.z, v.z))), 0.0f);
  return f3(quo(v.x, n), quo(v.y, n), quo(v.z, n));
}

}  // namespace
