// The photon pass's retry round in one launch: the walk kernel of walk.cuh
// (K2's walk, one 128-row chunk a group) under the policy GiPhotonRound.
//
// Replaces no TPU kernel: the JAX package runs a round as XLA operations
// (gi_raytracer_tpu/render/photon.py, _emit_attempts under lax.scan).  The
// port's plain version is the staged round of render/photon.py: about
// 3,700 torch operations a round with six K2 launches among them, each
// issued by the host, which leaves the card idle most of the pass.  In one
// launch instead, a block owns a tile of GI_TILE consecutive slots of the
// chunk, one thread a slot, and does the whole round: the emission (Halton
// dims 0 and 1, the light point, the threefry draw of the direction), the
// emission trace and photon_depth chain steps, each the walk of walk.cuh
// over the tile's live slots with the staged launch's salt, ray id, eps and
// active set, so it keeps the same winners; after each walk the exact
// Moller-Trumbore recompute, the hit attributes and the material from the
// scene's packed shade rows (render/shading.build_prim_rows: constant and
// checker textures), the BSDF draw, the colour and the first diffuse hit's
// store.  A slot stored in the round is written into the chunk's arrays in
// place and counted into the chunk's stored count (one atomicAdd a block),
// which the host reads to end the chunk's rounds early.
//
// The arithmetic follows the staged round operation for operation, as
// torch's CUDA kernels round it (torch_f32.cuh): every product, sum and
// quotient rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn:
// never contracted into an FMA) except where torch's kernel contracts it
// (the cross product); a sum over the three components of a vector in
// torch's reduction order; the same sqrtf, cosf, sinf and powf.  The walk
// itself is compiled as in intersect.cu (the same source and flags), so its
// approximate t and accept test are K2's.
//
// What bounds it on the card: the walks' ray-triangle tests (FP32 issue, as
// K2), and past them the shading arithmetic of the live slots; a round of a
// 131,072-slot chunk is one launch and one read of the count on the host.

#include "torch_f32.cuh"
#include "walk.cuh"

#define GI_PHOTON_MAX_DEPTH 16  // chain steps a round can take

namespace {

// torch.pow(base, exponent) on float32 tensors
__device__ __forceinline__ float tpow(float b, float e) { return powf(b, e); }

constexpr float kTwoPi = 6.283185307179586f;  // float32 of Python's 2 * pi

// ---- render/geom.py --------------------------------------------------------
// reflect(i, n): i - (2 * dot(n, i)) * n
__device__ __forceinline__ F3 reflect3(F3 i, F3 n) {
  return sub3(i, scale3(mul(2.0f, dot3(n, i)), n));
}

// _frame_apply(axis, local): the branchless |z| frame
__device__ __forceinline__ F3 frame_apply(F3 n, F3 l) {
  const float z = fabsf(n.z);
  const float inv = rcp(add(z, 1.0f));
  const float xy = mul(mul(-n.x, n.y), inv);
  const F3 c0 = f3(add(z, mul(mul(n.y, n.y), inv)), xy, -n.x);
  const F3 c1 = f3(xy, add(z, mul(mul(n.x, n.x), inv)), -n.y);
  const F3 c2 = f3(n.x, n.y, z);
  F3 o = add3(add3(scale3(l.x, c0), scale3(l.y, c1)), scale3(l.z, c2));
  if (n.z < 0.0f) o.z = -o.z;
  return o;
}

// the local (cos phi sin t, sin phi sin t, cos t) of a sample
__device__ __forceinline__ F3 polar(float phi, float sin_t, float cos_t) {
  return f3(mul(cosf(phi), sin_t), mul(sinf(phi), sin_t), cos_t);
}

// _cos_power_local(u, v, power) with the clamp(1 - u, 0) ** (1 / power)
// given: cos_t
__device__ __forceinline__ F3 cos_power_local(float v, float cos_t) {
  const float sin2 = clamp_min(sub(1.0f, mul(cos_t, cos_t)), 0.0f);
  const float sin_t = sin2 > 0.0f ? __fsqrt_rn(sin2) : 0.0f;
  return polar(mul(v, kTwoPi), sin_t, cos_t);
}

// sphere_cap_cos(axis, u, v, power, frac) for power 1 (pw = sqrt: false;
// torch.pow(x, 1.0) copies x) or 2 (pw = sqrt: true, torch.pow(x, 0.5) is
// torch.sqrt)
__device__ __forceinline__ F3 sphere_cap_cos(F3 axis, float u, float v,
                                             bool pw_sqrt, float frac) {
  const float base = clamp_min(sub(1.0f, u), 0.0f);
  const float cos_t = add(mul(frac, pw_sqrt ? __fsqrt_rn(base) : base),
                          sub(1.0f, frac));
  const float sin_t =
      __fsqrt_rn(clamp_min(sub(1.0f, mul(cos_t, cos_t)), 0.0f));
  return frame_apply(axis, polar(mul(v, kTwoPi), sin_t, cos_t));
}

// random_unit_vec(x, y)
__device__ __forceinline__ F3 random_unit_vec(float x, float y) {
  const float z = clamp(sub(mul(2.0f, y), 1.0f), -1.0f, 1.0f);
  const float st = __fsqrt_rn(clamp_min(sub(1.0f, mul(z, z)), 0.0f));
  const float a = mul(kTwoPi, x);
  return f3(mul(st, cosf(a)), mul(st, sinf(a)), z);
}

// refract_tir(inc, n, eta), eps 1e-5
__device__ __forceinline__ F3 refract_tir(F3 inc, F3 n, float eta) {
  const float d = dot3(n, inc);
  const float k = sub(1.0f, mul(mul(eta, eta), sub(1.0f, mul(d, d))));
  if (k < 1e-5f) return reflect3(inc, n);
  const float w = add(mul(eta, d), __fsqrt_rn(clamp_min(k, 0.0f)));
  return sub3(scale3(eta, inc), scale3(w, n));
}

// ---- the random streams ------------------------------------------------------
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry-2x32, 20 rounds (sampling/rng.threefry2x32)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// element `ctr` of rng.uniform(key, shape, float32): counter (0, ctr), the
// top 23 bits of the xor of the two words as the mantissa of [1, 2)
__device__ __forceinline__ float uniform01(uint32_t k0, uint32_t k1,
                                           uint32_t ctr) {
  uint32_t x0 = 0u, x1 = ctr;
  threefry2x32(k0, k1, x0, x1);
  return sub(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
}

// ---- render/shading.py on a packed shade row (PR_* columns) ----------------
// texture descriptor at `d` (14 columns) at (u, v): constant or checker
__device__ __forceinline__ F3 tex_eval(const float* __restrict__ d, float u,
                                       float v) {
  const F3 c0 = f3(__ldg(d + 8), __ldg(d + 9), __ldg(d + 10));
  if (__ldg(d) != 1.0f) return c0;  // TEX_CONST (image textures refused)
  const float iu = truncf(mul(u, __ldg(d + 6)));
  const float iv = truncf(mul(v, __ldg(d + 7)));
  const bool even_u = fmodf(fabsf(iu), 2.0f) < 0.5f;
  const bool even_v = fmodf(fabsf(iv), 2.0f) < 0.5f;
  if (even_u != even_v) return c0;
  return f3(__ldg(d + 11), __ldg(d + 12), __ldg(d + 13));
}

// a hit of the round: the exact recompute and the hit attributes
struct Hit {
  bool valid;
  F3 point, normal;
  float u, v;    // texture coordinates
  const float* row;
};

// exact_hit + hit_attributes_uv of triangle `prim` (-1: no hit) of a
// triangle-only scene, from its shade row
__device__ __forceinline__ Hit hit_at(const float* __restrict__ rows,
                                      int prim, F3 ro, F3 rd, float eps) {
  Hit h;
  h.row = rows + (size_t)(prim < 0 ? 0 : prim) * 64;
  const float* r = h.row;
  float t = 0.0f, bu = 0.0f, bv = 0.0f;
  h.valid = false;
  if (prim >= 0) {
    const F3 v0 = f3(__ldg(r + 0), __ldg(r + 1), __ldg(r + 2));
    const F3 e1 = f3(__ldg(r + 3), __ldg(r + 4), __ldg(r + 5));
    const F3 e2 = f3(__ldg(r + 6), __ldg(r + 7), __ldg(r + 8));
    const F3 p = cross3(rd, e2);
    const float det = dot3(e1, p);
    const bool ok = fabsf(det) >= eps;
    const float inv_det = ok ? rcp(det) : 0.0f;
    const F3 tv = sub3(ro, v0);
    const float u = mul(dot3(tv, p), inv_det);
    const F3 q = cross3(tv, e1);
    const float v = mul(dot3(rd, q), inv_det);
    const float tt = mul(dot3(e2, q), inv_det);
    if (ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && add(u, v) <= 1.0f &&
        tt > 0.0f) {
      h.valid = true;
      t = tt;
      bu = u;
      bv = v;
    }
  }
  h.point = add3(ro, scale3(t, rd));
  const float w0 = sub(sub(1.0f, bu), bv);
  if (__ldg(r + 27) > 0.5f) {  // PR_HASVN: the vertex normals
    h.normal = add3(add3(scale3(w0, f3(__ldg(r + 9), __ldg(r + 10),
                                       __ldg(r + 11))),
                         scale3(bu, f3(__ldg(r + 12), __ldg(r + 13),
                                       __ldg(r + 14)))),
                    scale3(bv, f3(__ldg(r + 15), __ldg(r + 16),
                                  __ldg(r + 17))));
    h.u = add(add(mul(w0, __ldg(r + 18)), mul(bu, __ldg(r + 20))),
              mul(bv, __ldg(r + 22)));
    h.v = add(add(mul(w0, __ldg(r + 19)), mul(bu, __ldg(r + 21))),
              mul(bv, __ldg(r + 23)));
  } else {
    h.normal = f3(__ldg(r + 24), __ldg(r + 25), __ldg(r + 26));  // PR_FACEN
    h.u = 0.0f;
    h.v = 0.0f;
  }
  return h;
}

// secondary_ray: the continuation direction, the flipped normal and the
// offset sign
struct Secondary {
  F3 dir, n;
  float sign;
};

__device__ __forceinline__ Secondary secondary_ray(F3 rd, F3 normal,
                                                   float alpha, float rough,
                                                   float ior, float sx,
                                                   float sy, float u_opac,
                                                   float u_fres) {
  const bool back = dot3(normal, rd) > 0.0f;
  const F3 n = back ? f3(-normal.x, -normal.y, -normal.z) : normal;
  const F3 refl = reflect3(rd, n);
  int typ = rough < 0.001f ? 0 : 2;
  if (u_opac > alpha) {  // the opacity lottery: Fresnel picks
    const float q = quo(sub(1.0f, ior), add(ior, 1.0f));
    const float r0 = mul(q, q);
    const float fs = add(r0, mul(sub(1.0f, r0),
                                 tpow(sub(1.0f, dot3(refl, n)), 5.0f)));
    typ = u_fres < fs ? 0 : 1;
  }
  Secondary s;
  s.n = n;
  s.sign = typ == 1 ? -1.0f : 1.0f;
  if (typ == 0) {
    s.dir = refl;
  } else if (typ == 1) {
    s.dir = refract_tir(rd, n, back ? ior : rcp(ior));
  } else if (rough < 0.9f) {  // Phong lobe about the mirror direction
    const float power = add(rcp(clamp_min(rough, 1e-6f)), 1.0f);
    const float cos_t = tpow(clamp_min(sub(1.0f, sx), 0.0f), rcp(power));
    F3 d = frame_apply(refl, cos_power_local(sy, cos_t));
    if (dot3(d, n) < 0.0f) d = reflect3(d, n);
    s.dir = d;
  } else {  // diffuse: cosine-weighted, torch.pow(x, 0.5) = torch.sqrt
    const float cos_t = __fsqrt_rn(clamp_min(sub(1.0f, sx), 0.0f));
    s.dir = frame_apply(n, cos_power_local(sy, cos_t));
  }
  return s;
}

}  // namespace

// The round: one thread a slot of the chunk.
struct GiPhotonRound {
  static constexpr int kMinBlocks = 2;
  struct Args {
    // the walk: K2's tables
    const float4* __restrict__ feat;
    const float* __restrict__ accept;
    const float* __restrict__ cbox;
    int n_groups;  // = chunks
    int all_opaque_i;
    float eps;
    // (T_pad, 64) shade rows; the light's 11 constants: pos 3, dir 3,
    // radius, cone fraction, the emitted colour 3
    const float* __restrict__ rows;
    const float* __restrict__ light;
    // the chunk, updated in place, and its stored count
    float* __restrict__ pos;
    float* __restrict__ dir;
    float* __restrict__ col;
    uint8_t* __restrict__ stored;
    int32_t* __restrict__ n_stored;
    int n_slots, start, retries, rnd, depth;
    uint32_t salt0;
    // Halton dim 1: base-3 digit permutation (2 bits a digit), digits, scale
    uint32_t perm3;
    int digits3;
    float scale3;
    float shadow_bias;
    // threefry keys: the emission direction's, then each chain step's
    uint32_t keys[2 * (1 + GI_PHOTON_MAX_DEPTH)];
  };

  template <int GC>
  __device__ __forceinline__ static void tile(const Args& a,
                                              const GiWalkSmem& s) {
    const int i = blockIdx.x * GI_TILE + threadIdx.x;
    const bool act = i < a.n_slots && !a.stored[i];
    if (!__syncthreads_or(act)) return;  // every slot of the tile stored
    const uint32_t lane_i = (uint32_t)i;
    const uint32_t slot = (uint32_t)a.start + lane_i;
    const uint32_t R = (uint32_t)a.n_slots;
    const bool all_opaque = a.all_opaque_i != 0;
    const float* L = a.light;
    const float langle = __ldg(L + 7);
    F3 ro = f3(0.0f, 0.0f, 0.0f), rd = ro, col = ro;
    if (act) {
      // Halton dims 0 and 1 of index slot * retries + round
      const uint32_t h = slot * (uint32_t)a.retries + (uint32_t)a.rnd;
      const float sx =
          sub(__uint_as_float((__brev(h) >> 9) | 0x3F800000u), 1.0f);
      uint32_t acc = 0u, div = h;
      for (int j = 0; j < a.digits3; ++j) {
        acc = acc * 3u + ((a.perm3 >> (2 * (div % 3u))) & 3u);
        div /= 3u;
      }
      const float sy = mul(__uint2float_rn(acc), a.scale3);
      // the light point
      const F3 lpos = f3(__ldg(L), __ldg(L + 1), __ldg(L + 2));
      const F3 ldir = f3(__ldg(L + 3), __ldg(L + 4), __ldg(L + 5));
      const F3 surf = langle < 1.0f
                          ? sphere_cap_cos(ldir, sx, sy, false, langle)
                          : random_unit_vec(sx, sy);
      ro = add3(lpos, scale3(__ldg(L + 6), surf));
      // the emission direction
      const float u0 = uniform01(a.keys[0], a.keys[1], lane_i);
      const float u1 = uniform01(a.keys[0], a.keys[1], R + lane_i);
      rd = sphere_cap_cos(normalize3(sub3(ro, lpos)), u0, u1, true, langle);
      col = f3(__ldg(L + 8), __ldg(L + 9), __ldg(L + 10));
    }
    bool alive = act, stored = false;
    int nv, nt = 0;
    // the emission trace (d = -1), then the chain steps
    for (int d = -1; d < a.depth; ++d) {
      if (!__syncthreads_or(alive)) break;  // no live slot left in the tile
      const uint32_t salt = a.salt0 + (uint32_t)(d + 1) * 7919u;
      const unsigned long long key = gi_walk_tile<GC>(
          s, a.feat, a.accept, a.cbox, a.cbox, a.n_groups, a.n_groups, alive,
          ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, alive ? GI_BIG : -GI_BIG, slot,
          salt, a.eps, false, all_opaque, nv, nt);
      if (!alive) continue;
      const int prim = key == GI_NO_HIT ? -1 : (int)(uint32_t)key;
      const Hit h = hit_at(a.rows, prim, ro, rd, a.eps);
      const float rough = __ldg(h.row + 28);  // PR_ROUGH
      if (!h.valid) {
        alive = false;
      } else if (d < 0) {  // specular first hits only
        alive = rough < 0.1f;
      } else {
        const F3 color = tex_eval(h.row + 31, h.u, h.v);  // PR_TEXD
        // step d's key, picked by constant indices (a kernel parameter
        // indexed by a variable would be copied to local memory)
        uint32_t k0 = 0u, k1 = 0u;
#pragma unroll
        for (int j = 1; j <= GI_PHOTON_MAX_DEPTH; ++j)
          if (j == d + 1) k0 = a.keys[2 * j], k1 = a.keys[2 * j + 1];
        const Secondary sec = secondary_ray(
            rd, h.normal, __ldg(h.row + 29), rough, __ldg(h.row + 30),
            uniform01(k0, k1, lane_i), uniform01(k0, k1, R + lane_i),
            uniform01(k0, k1, 2u * R + lane_i),
            uniform01(k0, k1, 3u * R + lane_i));
        col = mul3(col, color);
        ro = add3(h.point, scale3(mul(sec.sign, a.shadow_bias), sec.n));
        rd = sec.dir;
        alive = rough < 0.1f;
        // the first diffuse hit after the specular chain stores the photon
        if (rough >= 0.1f && !stored) {
          stored = true;
          a.pos[3 * i] = h.point.x;
          a.pos[3 * i + 1] = h.point.y;
          a.pos[3 * i + 2] = h.point.z;
          a.dir[3 * i] = sec.dir.x;
          a.dir[3 * i + 1] = sec.dir.y;
          a.dir[3 * i + 2] = sec.dir.z;
          a.col[3 * i] = col.x;
          a.col[3 * i + 1] = col.y;
          a.col[3 * i + 2] = col.z;
          a.stored[i] = 1;
        }
      }
    }
    const int n_new = __syncthreads_count(stored);
    if (threadIdx.x == 0 && n_new) atomicAdd(a.n_stored, n_new);
  }
};

extern "C" int gi_photon_round_launch(
    const float* feat, const float* accept, const float* cbox, int t_pad,
    int all_opaque, float eps, const float* rows, const float* light,
    float* pos, float* dir, float* col, uint8_t* stored, int32_t* n_stored,
    int n_slots, int start, int retries, int rnd, int depth, uint32_t salt0,
    uint32_t perm3, int digits3, float scale3, float shadow_bias,
    const uint32_t* keys, cudaStream_t stream) {
  const int n_chunks = t_pad / GI_CHUNK;
  if (n_chunks > GI_MAX_GROUPS || n_chunks < 1 || depth < 0 ||
      depth > GI_PHOTON_MAX_DEPTH || n_slots < 0)
    return (int)cudaErrorInvalidValue;
  GiPhotonRound::Args a;
  a.feat = reinterpret_cast<const float4*>(feat);
  a.accept = accept;
  a.cbox = cbox;
  a.n_groups = n_chunks;
  a.all_opaque_i = all_opaque;
  a.eps = eps;
  a.rows = rows;
  a.light = light;
  a.pos = pos;
  a.dir = dir;
  a.col = col;
  a.stored = stored;
  a.n_stored = n_stored;
  a.n_slots = n_slots;
  a.start = start;
  a.retries = retries;
  a.rnd = rnd;
  a.depth = depth;
  a.salt0 = salt0;
  a.perm3 = perm3;
  a.digits3 = digits3;
  a.scale3 = scale3;
  a.shadow_bias = shadow_bias;
  for (int k = 0; k < 2 * (1 + GI_PHOTON_MAX_DEPTH); ++k)
    a.keys[k] = k < 2 * (1 + depth) ? keys[k] : 0u;
  return gi_walk_run<1, GiPhotonRound>(a, (n_slots + GI_TILE - 1) / GI_TILE,
                                       stream);
}

extern "C" int gi_photon_round_info(int t_pad, int* out) {
  return gi_walk_info<1, GiPhotonRound>(t_pad / GI_CHUNK, out);
}
