// A wave's set-up in one launch: every Halton dim and the primary rays of
// a render wave (Renderer.wave_inputs in render/integrator.py).
//
// Replaces no TPU kernel: the JAX package leaves this arithmetic to XLA's
// fusion (gi_raytracer_tpu/render/integrator.py, _make_wave_inputs).  The
// port's plain version is Renderer.wave_inputs_plain, HaltonSampler.sample
// of every dim and camera.primary_rays as torch code: some 880 int64 torch
// operations a 512x512 wave of depth 8 (a per-digit loop of %, //, a
// permutation gather, * and + a dim), each issued by the host, which left
// the card idle most of the frame.  Here one thread owns one lane of the
// wave (block-ordered position p, or pos[p] on a block wave) and does all
// of it:
//
//   * the lane's Halton index on native uint32: offsets[perm[p]] plus the
//     wave's offset, as wave_inputs forms it (& 0xFFFFFFFF is the uint32
//     wrap);
//   * dim 0 by bit reversal (sampling/halton.halton2), every other dim
//     1 ... 1 + 2 depth by HaltonSampler._sample_arith's per-digit loop
//     over the digits an index can set and its tail for the zero digits
//     past them (arith_plan), with the digit permutations of every base
//     up to 150 staged from one table in shared memory, and converted as
//     torch converts: uint32 -> float32 rounded to nearest, times the
//     float32 scale;
//   * the primary ray through (dx, dy) from the frame's camera constants
//     (render/camera.ray_frame, computed once a frame by torch), in
//     primary_rays' order of operations with torch's CUDA rounding
//     (torch_f32.cuh: nothing contracted into an FMA; a division by a
//     Python number is a product with its float32 reciprocal), and
//     normalised as geom.normalize is on the card.
//
// It writes sx_all and sy_all as (depth, R) float32, torch.stack's layout,
// and rd as (R, 3); ro is the caller's broadcast view of the camera
// position.  The results are the plain version's bit for bit.
//
// What bounds it: its output bytes (4 (2 depth + 3) a lane: 20 MB for a
// 512x512 wave of depth 8, 0.006 ms at 3.35 TB/s) and some 100 integer
// digit steps a lane, each a division by a base known only at run time,
// which set its time: about 0.035 ms for that wave on an H100, a few
// percent of the K1 launch beside it.  Lanes share nothing but the
// tables, so one thread a lane suffices: no lane's work depends on
// another's, the writes of a warp are coalesced along R, and a 512x512
// wave fills the card with 1,024 blocks.

#include <stdint.h>
#include <string.h>

#include "torch_f32.cuh"

#define GI_WAVE_THREADS 256
#define GI_WAVE_MAX_DIMS 34     // 2 + 2 * 16: every dim of a base <= 150
#define GI_WAVE_MAX_PERMS 2276  // the permutations of the 35 primes <= 150

namespace {

// one Halton dim past dim 0: its base, its permutation's first entry in the
// table, the digits evaluated, the tail (acc * shift + tail, mod 2^32) and
// the float32 scale
struct GiDim {
  uint32_t base, first, digits, shift, tail;
  float scale;
};

struct GiWaveArgs {
  const int64_t* __restrict__ offsets;  // the band's raster Halton offsets
  const int64_t* __restrict__ perm;     // block-ordered position -> pixel
  const int64_t* __restrict__ pos;      // the lanes' positions, or null
  const uint8_t* __restrict__ perms;    // the digit permutations
  // pos 3, up 3, cam_right 3, screen centre 3, half-width, half-height
  const float* __restrict__ cam;
  float* __restrict__ sx;  // (depth, R)
  float* __restrict__ sy;  // (depth, R)
  float* __restrict__ rd;  // (R, 3)
  int n_lanes, depth, n_perms;
  uint32_t wave_offset;
  float scale_x, scale_y, inv_w, inv_h;
  GiDim dim[GI_WAVE_MAX_DIMS];  // dims 1 ... 1 + 2 depth at [1 ...]
};

__global__ void __launch_bounds__(GI_WAVE_THREADS)
    gi_wave_inputs_kernel(const GiWaveArgs a) {
  __shared__ uint8_t s_perm[GI_WAVE_MAX_PERMS];
  __shared__ GiDim s_dim[GI_WAVE_MAX_DIMS];
  for (int k = threadIdx.x; k < a.n_perms; k += GI_WAVE_THREADS)
    s_perm[k] = a.perms[k];
  // constant indices: a kernel parameter indexed by a variable would be
  // copied to local memory
#pragma unroll
  for (int k = 0; k < GI_WAVE_MAX_DIMS; ++k)
    if (threadIdx.x == k) s_dim[k] = a.dim[k];
  __syncthreads();
  const int i = blockIdx.x * GI_WAVE_THREADS + threadIdx.x;
  if (i >= a.n_lanes) return;
  const int64_t p = a.pos != nullptr ? a.pos[i] : (int64_t)i;
  const uint32_t h = (uint32_t)a.offsets[a.perm[p]] + a.wave_offset;
  const float xr =
      sub(__uint_as_float((__brev(h) >> 9) | 0x3F800000u), 1.0f);
  float yr = 0.0f;
  const size_t R = (size_t)a.n_lanes;
  for (int d = 1; d < 2 + 2 * a.depth; ++d) {
    const GiDim g = s_dim[d];
    uint32_t acc = 0u, div = h;
    for (uint32_t j = 0; j < g.digits; ++j) {
      const uint32_t q = div / g.base;
      acc = acc * g.base + s_perm[g.first + (div - q * g.base)];
      div = q;
    }
    const float u = mul(__uint2float_rn(acc * g.shift + g.tail), g.scale);
    if (d == 1) {
      yr = u;
    } else {  // bounce (d - 2) / 2: dim 2 + 2 b is its x, 3 + 2 b its y
      const int b = (d - 2) >> 1;
      ((d & 1) ? a.sy : a.sx)[(size_t)b * R + i] = u;
    }
  }
  // primary_rays(cam, width, height, xr * scale_x, yr * scale_y)
  const float* c = a.cam;
  const F3 eye = f3(__ldg(c), __ldg(c + 1), __ldg(c + 2));
  const F3 up = f3(__ldg(c + 3), __ldg(c + 4), __ldg(c + 5));
  const F3 right = f3(__ldg(c + 6), __ldg(c + 7), __ldg(c + 8));
  const F3 center = f3(__ldg(c + 9), __ldg(c + 10), __ldg(c + 11));
  const float dx = mul(xr, a.scale_x), dy = mul(yr, a.scale_y);
  const float hx = mul(__ldg(c + 12), sub(mul(dx, a.inv_w), 0.5f));
  const float hy = mul(__ldg(c + 13), sub(mul(dy, a.inv_h), 0.5f));
  const F3 pixel = sub3(add3(center, scale3(hx, right)), scale3(hy, up));
  const F3 dir = normalize3(sub3(pixel, eye));
  a.rd[3 * i] = dir.x;
  a.rd[3 * i + 1] = dir.y;
  a.rd[3 * i + 2] = dir.z;
}

}  // namespace

// plan: (2 + 2 depth - 1, 6) uint32 on the host, dims 1 ... 1 + 2 depth:
// base, first entry, digits, shift, tail, the scale's float32 bits
extern "C" int gi_wave_inputs_launch(
    const int64_t* offsets, const int64_t* perm, const int64_t* pos,
    const uint8_t* perms, int n_perms, const float* cam, int n_lanes,
    int depth, uint32_t wave_offset, float scale_x, float scale_y, float inv_w,
    float inv_h, const uint32_t* plan, float* sx, float* sy, float* rd,
    cudaStream_t stream) {
  if (n_lanes < 1 || depth < 0 || 2 + 2 * depth > GI_WAVE_MAX_DIMS ||
      n_perms < 0 || n_perms > GI_WAVE_MAX_PERMS)
    return (int)cudaErrorInvalidValue;
  GiWaveArgs a = {};
  a.offsets = offsets;
  a.perm = perm;
  a.pos = pos;
  a.perms = perms;
  a.cam = cam;
  a.sx = sx;
  a.sy = sy;
  a.rd = rd;
  a.n_lanes = n_lanes;
  a.depth = depth;
  a.n_perms = n_perms;
  a.wave_offset = wave_offset;
  a.scale_x = scale_x;
  a.scale_y = scale_y;
  a.inv_w = inv_w;
  a.inv_h = inv_h;
  for (int d = 1; d < 2 + 2 * depth; ++d) {
    const uint32_t* row = plan + 6 * (d - 1);
    a.dim[d].base = row[0];
    a.dim[d].first = row[1];
    a.dim[d].digits = row[2];
    a.dim[d].shift = row[3];
    a.dim[d].tail = row[4];
    memcpy(&a.dim[d].scale, row + 5, sizeof(float));
  }
  const int blocks = (n_lanes + GI_WAVE_THREADS - 1) / GI_WAVE_THREADS;
  gi_wave_inputs_kernel<<<blocks, GI_WAVE_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
