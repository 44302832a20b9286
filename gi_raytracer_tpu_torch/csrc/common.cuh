// Shared device helpers for the port's kernels: the murmur3-finalizer
// hashes (bit-exact with gi_raytracer_tpu.sampling.rng.hash_u01 and the
// TPU kernels' alpha stream) and the separable Moller-Trumbore test.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GI_BIG 3.0e38f
#define GI_PI 3.141592653589793f

__device__ __forceinline__ uint32_t gi_mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// top 24 bits -> int32 -> float32, as the reference converts
__device__ __forceinline__ float gi_bits_u01(uint32_t h) {
  return (float)(int32_t)(h >> 8) * 5.960464477539063e-08f;
}

// sampling.rng.hash_u01(a, b, c)
__device__ __forceinline__ float gi_hash_u01(uint32_t a, uint32_t b,
                                             uint32_t c) {
  return gi_bits_u01(gi_mix((a * 0x9E3779B9u) ^ gi_mix((b + 0x7F4A7C15u) ^
                                                       gi_mix(c))));
}

// the TPU trace kernels' stochastic-alpha stream: hash(ray id, prim, salt)
__device__ __forceinline__ float gi_alpha_u01(uint32_t rid, uint32_t prim,
                                              uint32_t salt) {
  return gi_bits_u01(gi_mix((rid * 0x9E3779B9u) ^
                            gi_mix((prim + 0x7F4A7C15u) ^ salt)));
}

// float -> bfloat16 -> float, round to nearest even (positive finite x)
__device__ __forceinline__ float gi_bf16_round(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// the TPU kernels' approximate reciprocal as the JAX reference computes it
// off the TPU: the float32 1/x of x rounded to bfloat16
__device__ __forceinline__ float gi_approx_rcp(float x) {
  return 1.0f / gi_bf16_round(x);
}

struct GiRay {
  float ox, oy, oz, dx, dy, dz;
  float cxx, cxy, cxz;  // ro x rd
};

__device__ __forceinline__ GiRay gi_make_ray(float ox, float oy, float oz,
                                             float dx, float dy, float dz) {
  GiRay r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.cxx = oy * dz - oz * dy;
  r.cxy = oz * dx - ox * dz;
  r.cxz = ox * dy - oy * dx;
  return r;
}

// Separable homogeneous Moller-Trumbore accept test on one feature row
// f[16] = [n2 xyz, fu xyz, fv xyz, d0, e1 xyz, e2 xyz] (the TPU kernels'
// form, pallas_megakernel.py:213-228, approximate reciprocal included).
// The row comes as its four float4 quads a = (n2x n2y n2z fux), b = (fuy
// fuz fvx fvy), c = (fvz d0 e1x e1y), d = (e1z e2x e2y e2z).  Returns the
// approximate t, or a negative value when the triangle is not hit.
__device__ __forceinline__ float gi_tri_test4(const GiRay& r, const float4 a,
                                              const float4 b, const float4 c,
                                              const float4 d, float eps) {
  const float m = r.dx * a.x + r.dy * a.y + r.dz * a.z;
  const float sm = m >= 0.0f ? 1.0f : -1.0f;
  const float ds = m * sm;
  const float ns = -sm;
  const float u_num = (r.cxx * d.y + r.cxy * d.z + r.cxz * d.w) +
                      (r.dx * a.w + r.dy * b.x + r.dz * b.y);
  const float v_sum = (r.cxx * c.z + r.cxy * c.w + r.cxz * d.x) +
                      (r.dx * b.z + r.dy * b.w + r.dz * c.x);
  const float t_num = (r.ox * a.x + r.oy * a.y + r.oz * a.z) - c.y;
  const float us = u_num * ns;
  const float vs = v_sum * sm;
  const float ts = t_num * ns;
  const bool ok = (ds >= eps) & (us >= 0.0f) & (vs >= 0.0f) &
                  (us + vs <= ds) & (ts > 0.0f);
  if (!ok) return -1.0f;
  return ts * gi_approx_rcp(fmaxf(ds, 1e-30f));
}

// gi_tri_test4 on the feature row at f4 (four float4 quads in device memory)
__device__ __forceinline__ float gi_tri_test(const GiRay& r,
                                             const float4* __restrict__ f4,
                                             float eps) {
  return gi_tri_test4(r, __ldg(f4 + 0), __ldg(f4 + 1), __ldg(f4 + 2),
                      __ldg(f4 + 3), eps);
}
