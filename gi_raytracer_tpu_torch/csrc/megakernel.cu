// K1: the bounce megakernel -- one radiance wave in one launch.
//
// Replaces gi_raytracer_tpu/ops/pallas_megakernel.py::_mega_kernel
// (launched by _mega_call, helpers _trace_tile and _tile_cull).  The TPU
// kernel runs the whole depth-D bounce loop for a 256-ray tile with path
// state in VMEM and extracts the winner's shade row with a one-hot MXU
// contraction.  Here a thread carries one path at a time and keeps its
// state in registers (D <= 16, L <= 4):
//
//   closest hit -> direct load of the winner's attr row (in place of the
//   one-hot extraction) -> exact MT recompute -> shading with
//   constant/checker textures -> secondary direction (Phong, mirror,
//   refraction, Fresnel, opacity) -> one any-hit shadow ray per light ->
//   direct light -> Russian roulette -> accumulation -> caustic query
//   record.  Every decision uniform replays sampling.rng.hash_u01 with
//   native uint32 arithmetic.
//
// What bounds it on the card: the ray-triangle tests of the two walks per
// bounce (closest + shadow), i.e. FP32 issue rate on the separable MT
// test and the shared-memory reads of the feature rows.  The design cuts
// the tests a ray makes and keeps every lane of a warp busy with them:
//
//   * the culled walk: a ray visits the 128-row chunks in index order and
//     skips every chunk whose box (ops/intersect.chunk_boxes, staged in
//     shared memory) it does not enter before its t limit and, for a
//     closest hit, at or before its best t so far.  The closest hit is
//     the least (approximate t, prim) key, so the winner does not depend
//     on the visit order; a shadow ray stops at its first accepted row.
//     Index order measured faster than ascending box entry on the
//     Cornell box and the 8,342-triangle glass box (PERF.md, PR 4).
//   * a warp-cooperative test of each (ray, chunk) pair: per chunk, the
//     lanes whose rays need it are taken one at a time and the whole warp
//     tests that ray against the chunk's rows, 32 at once, with a warp
//     min-reduction of the 64-bit keys (a ballot for a shadow ray).  No
//     lane idles on a chunk another lane's ray needs, and no block-wide
//     barrier is taken.
//   * rows from shared memory: the feature table is stored as four planes
//     of float4 (neighbouring rows on neighbouring 16-byte words, so a
//     warp's 32 rows are read without bank conflicts).  When the table,
//     its accept column and the boxes fit a block's shared memory (the
//     Cornell box: 2,304 rows, 157,104 B), each block copies them in once
//     with cp.async and walks them there; past that size the same walk
//     reads the planes from device memory through __ldg (template SMEM).
//   * persistent blocks with a lane queue, in place of compaction between
//     bounces: the grid is as many blocks as fit the card at once, and a
//     thread whose path ended (miss, roulette or depth D) takes the next
//     lane of the wave from a queue counter (one atomicAdd per warp for
//     all its free threads), so warps stay full of live paths until the
//     lanes run out.  Paths of one warp may be at different depths; a
//     path keeps its lane index for its samples sx_all[d, i], its caustic
//     record slots (i, d) and out[i].
//
// Unlike the TPU kernel, closest hits are not capped at the world-box
// diagonal (pallas_megakernel.py:174): that cap loses the far walls when
// the camera sits outside the scene's box, as the Cornell camera at
// z = -14 does.  Shadow rays are limited by the light distance alone, as
// in the staged integrator.

#include "walk.cuh"

namespace {

constexpr float kPi = 3.141592653589793f;
constexpr int kAttrW = 64;
constexpr uint32_t kDecisionTag = 0x80000000u;
constexpr unsigned kFull = 0xffffffffu;
// threads per block, one block per SM: 16 warps at up to 128 registers,
// no spills.  640 threads (96 registers) were no faster and 768 (80)
// slower, and both spilled (NVIDIA H100 80GB HBM3, 700 W).
constexpr int kThreads = 512;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x; r.y = y; r.z = z;
  return r;
}
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 reflect3(V3 i, V3 n) {
  const float d = dot3(n, i);
  return v3(i.x - 2.0f * d * n.x, i.y - 2.0f * d * n.y, i.z - 2.0f * d * n.z);
}
__device__ __forceinline__ V3 normalize3(V3 v) {
  const float inv = rsqrtf(fmaxf(dot3(v, v), 1e-30f));
  return v3(v.x * inv, v.y * inv, v.z * inv);
}
// geom._frame_apply: rotate a z-up local vector into the frame of n
__device__ __forceinline__ V3 frame_apply(V3 n, V3 l) {
  const float z = fabsf(n.z);
  const float inv = 1.0f / (1.0f + z);
  const float ox = l.x * (z + n.y * n.y * inv) + l.y * (-n.x * n.y * inv) +
                   l.z * n.x;
  const float oy = l.x * (-n.x * n.y * inv) + l.y * (z + n.x * n.x * inv) +
                   l.z * n.y;
  const float oz = l.x * (-n.x) + l.y * (-n.y) + l.z * z;
  return v3(ox, oy, n.z < 0.0f ? -oz : oz);
}
// geom._cos_power_local with the power given as its reciprocal
__device__ __forceinline__ V3 cos_power_local(float u, float v,
                                              float inv_power) {
  const float phi = v * (2.0f * kPi);
  const float cos_t = powf(fmaxf(1.0f - u, 0.0f), inv_power);
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  return v3(cosf(phi) * sin_t, sinf(phi) * sin_t, cos_t);
}

__device__ __forceinline__ float decision_u(uint32_t rid, uint32_t purpose,
                                           uint32_t salt) {
  return gi_hash_u01(rid, kDecisionTag ^ purpose, salt);
}

// constant / checker texture from a 14-column descriptor
__device__ __forceinline__ V3 tex_eval(const float* __restrict__ row,
                                       int base, float uu, float vv) {
  const float kind = __ldg(row + base);
  const V3 c0 = v3(__ldg(row + base + 8), __ldg(row + base + 9),
                   __ldg(row + base + 10));
  if (kind != 1.0f) return c0;  // TEX_CONST (image textures not eligible)
  const float iu = truncf(uu * __ldg(row + base + 6));
  const float iv = truncf(vv * __ldg(row + base + 7));
  const bool even = (fmodf(fabsf(iu), 2.0f) < 0.5f) !=
                    (fmodf(fabsf(iv), 2.0f) < 0.5f);
  if (even) return c0;
  return v3(__ldg(row + base + 11), __ldg(row + base + 12),
            __ldg(row + base + 13));
}

__device__ __forceinline__ void write_record(float* __restrict__ rec,
                                             V3 p, V3 d, V3 w) {
  rec[0] = p.x; rec[1] = p.y; rec[2] = p.z;
  rec[3] = d.x; rec[4] = d.y; rec[5] = d.z;
  rec[6] = w.x; rec[7] = w.y; rec[8] = w.z;
}

// The path of lane i ends after bounce d: its radiance and ray counts
// (n_closest closest-hit rays, L shadow rays for each of n_hits hits), and
// far-sentinel caustic records for the bounces it did not reach.
__device__ __forceinline__ void end_path(float* __restrict__ out,
                                         float* __restrict__ caustic, int i,
                                         int d, int D, int L,
                                         int with_caustic, V3 rad,
                                         int n_closest, int n_hits) {
  float* o = out + (size_t)i * 8;
  o[0] = rad.x; o[1] = rad.y; o[2] = rad.z;
  o[3] = (float)n_closest; o[4] = (float)(L * n_hits);
  o[5] = 0.0f; o[6] = 0.0f; o[7] = 0.0f;
  if (with_caustic)
    for (int dd = d + 1; dd < D; ++dd)
      write_record(caustic + ((size_t)i * D + dd) * 9,
                   v3(1e30f, 1e30f, 1e30f), v3(0.0f, 0.0f, 0.0f),
                   v3(0.0f, 0.0f, 0.0f));
}

// The walk's tables: the planar feature rows (plane q of row p at
// rows[q * t_pad + p]) and accept values, in shared or device memory, and
// the chunk boxes (6, n_chunks) in shared memory.
struct MegaTab {
  const float4* rows;
  const float* acc;
  const float* box;
  int t_pad, n_chunks;
};

template <bool SMEM>
__device__ __forceinline__ float4 row_ld(const float4* p) {
  if constexpr (SMEM) return *p;
  else return __ldg(p);
}
template <bool SMEM>
__device__ __forceinline__ float acc_ld(const float* p) {
  if constexpr (SMEM) return *p;
  else return __ldg(p);
}

// a lane's ray: origin, direction, their cross product, the inverse
// direction for the box test, and its t limit
struct WalkRay {
  GiRay r;
  float ix, iy, iz, t_eff;
};

__device__ __forceinline__ WalkRay walk_ray(V3 o, V3 d, float t_eff) {
  WalkRay w;
  w.r = gi_make_ray(o.x, o.y, o.z, d.x, d.y, d.z);
  w.ix = gi_safe_inv(d.x);
  w.iy = gi_safe_inv(d.y);
  w.iz = gi_safe_inv(d.z);
  w.t_eff = t_eff;
  return w;
}

// entry of the ray into chunk c's box (gi_slab: BIG when culled)
__device__ __forceinline__ float chunk_entry(const MegaTab tb, int c,
                                             const WalkRay& w) {
  const int n = tb.n_chunks;
  const float lo[3] = {tb.box[c], tb.box[n + c], tb.box[2 * n + c]};
  const float hi[3] = {tb.box[3 * n + c], tb.box[4 * n + c],
                       tb.box[5 * n + c]};
  return gi_slab(lo, hi, w.r.ox, w.r.oy, w.r.oz, w.ix, w.iy, w.iz, w.t_eff);
}

// The warp tests chunk c's 128 rows for the ray of lane `src` (lane k on
// rows 32 it + k).  Closest hit: the warp's least key (t bits << 32 |
// prim) over the accepted rows with t < t_eff and t <= best_t, GI_NO_HIT
// when none.  Any hit: the first accepted row with t < t_eff (as its prim
// id), GI_NO_HIT when none.  `made` = the tests the walk needed: 128, or
// for any hit the rows up to and including the first accepted one.
template <bool SMEM, bool ANY>
__device__ __forceinline__ unsigned long long pair_test(
    const MegaTab tb, int c, const WalkRay& own, int src, float best_t,
    uint32_t rid, uint32_t salt, float eps, bool all_opaque, int& made) {
  const int lane = threadIdx.x & 31;
  GiRay r;
  r.ox = __shfl_sync(kFull, own.r.ox, src);
  r.oy = __shfl_sync(kFull, own.r.oy, src);
  r.oz = __shfl_sync(kFull, own.r.oz, src);
  r.dx = __shfl_sync(kFull, own.r.dx, src);
  r.dy = __shfl_sync(kFull, own.r.dy, src);
  r.dz = __shfl_sync(kFull, own.r.dz, src);
  r.cxx = __shfl_sync(kFull, own.r.cxx, src);
  r.cxy = __shfl_sync(kFull, own.r.cxy, src);
  r.cxz = __shfl_sync(kFull, own.r.cxz, src);
  const float t_eff = __shfl_sync(kFull, own.t_eff, src);
  const float bt = __shfl_sync(kFull, best_t, src);
  const uint32_t rid_s = __shfl_sync(kFull, rid, src);
  const uint32_t salt_s = __shfl_sync(kFull, salt, src);
  unsigned long long best = GI_NO_HIT;
  made = GI_CHUNK;
#pragma unroll 2
  for (int it = 0; it < GI_CHUNK / 32; ++it) {
    const int p = c * GI_CHUNK + it * 32 + lane;
    const float tc = gi_tri_test4(
        r, row_ld<SMEM>(tb.rows + p), row_ld<SMEM>(tb.rows + tb.t_pad + p),
        row_ld<SMEM>(tb.rows + 2 * tb.t_pad + p),
        row_ld<SMEM>(tb.rows + 3 * tb.t_pad + p), eps);
    bool ok = tc >= 0.0f && tc < t_eff && (ANY || tc <= bt);
    if (ok && !all_opaque) {
      const float a = acc_ld<SMEM>(tb.acc + p);
      ok = a >= 1.0f || gi_alpha_u01(rid_s, (uint32_t)p, salt_s) < a;
    }
    if constexpr (ANY) {
      const unsigned hits = __ballot_sync(kFull, ok);
      if (hits) {
        const int first = __ffs(hits) - 1;
        made = it * 32 + first + 1;
        return (unsigned long long)(c * GI_CHUNK + it * 32 + first);
      }
    } else if (ok) {
      const unsigned long long k =
          ((unsigned long long)__float_as_uint(tc) << 32) | (uint32_t)p;
      best = k < best ? k : best;
    }
  }
  if constexpr (!ANY) {
    const uint32_t hi = __reduce_min_sync(kFull, (uint32_t)(best >> 32));
    const uint32_t lo = __reduce_min_sync(
        kFull, (uint32_t)(best >> 32) == hi ? (uint32_t)best : ~0u);
    best = ((unsigned long long)hi << 32) | lo;
  }
  return best;
}

// One walk of the warp's rays (every lane calls it; `walks` false for a
// lane without a ray).  Returns the lane's closest accepted prim (ANY:
// an accepted prim before its t limit), or -1; adds the tests made to
// `tests`.  Chunks in index order; per chunk, the lanes that need it (box
// entered before t_eff and, closest hit, at or before the best t so far;
// any hit, no hit yet).
template <bool SMEM, bool ANY>
__device__ __forceinline__ int warp_walk(const MegaTab tb, const WalkRay& w,
                                      bool walks, uint32_t rid,
                                      uint32_t salt, float eps,
                                      bool all_opaque, uint32_t& tests) {
  const int lane = threadIdx.x & 31;
  unsigned long long best = GI_NO_HIT;
  float best_t = GI_BIG;
  bool open = walks;
  for (int c = 0; c < tb.n_chunks && __any_sync(kFull, open); ++c) {
    const float e = chunk_entry(tb, c, w);
    const bool need = open && e < GI_BIG && (ANY || e <= best_t);
    unsigned m = __ballot_sync(kFull, need);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      int made;
      const unsigned long long k = pair_test<SMEM, ANY>(
          tb, c, w, src, best_t, rid, salt, eps, all_opaque, made);
      if (lane == src) {
        tests += (uint32_t)made;
        if (k < best) {
          best = k;
          if (!ANY) best_t = __uint_as_float((uint32_t)(k >> 32));
        }
        if (ANY && k != GI_NO_HIT) open = false;
      }
    }
  }
  if (best == GI_NO_HIT) return -1;
  return (int)(uint32_t)best;
}

// dynamic shared memory: [rows: 4 t_pad float4][accept: t_pad][boxes:
// 6 n_chunks] with the table, or the boxes alone
__host__ __device__ inline size_t mega_smem_bytes(int t_pad, int n_chunks,
                                                  bool table) {
  return (table ? (size_t)t_pad * (64 + 4) : 0) +
         (((size_t)6 * n_chunks * 4 + 15) & ~(size_t)15);
}

template <bool SMEM>
__global__ void __launch_bounds__(kThreads, 1) gi_mega_kernel(
    const float* __restrict__ ro_in, const float* __restrict__ rd_in,
    const float* __restrict__ sx_all, const float* __restrict__ sy_all,
    const int32_t* __restrict__ rid_in, const float* __restrict__ attr,
    const float4* __restrict__ featp, const float* __restrict__ accept,
    const float* __restrict__ cbox, const float* __restrict__ lights,
    int n_rays, int t_pad, int D, int L, uint32_t salt0, float eps,
    float shadow_bias, int min_depth, float amb_r, float amb_g, float amb_b,
    int all_opaque_i, int with_caustic, int caustic_max_depth,
    float* __restrict__ out, float* __restrict__ caustic,
    int* __restrict__ queue, unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char gi_smem[];
  const int n_chunks = t_pad / GI_CHUNK;
  const bool all_opaque = all_opaque_i != 0;
  const int lane = threadIdx.x & 31;

  // ---- stage the tables (once per block) -------------------------------
  MegaTab tb;
  tb.t_pad = t_pad;
  tb.n_chunks = n_chunks;
  float* s_box;
  if constexpr (SMEM) {
    float4* s_rows = reinterpret_cast<float4*>(gi_smem);
    float* s_acc = reinterpret_cast<float*>(s_rows + 4 * t_pad);
    for (int k = threadIdx.x; k < 4 * t_pad; k += kThreads)
      gi_cp_async16(s_rows + k, featp + k);
    for (int k = threadIdx.x; k < t_pad / 4; k += kThreads)
      gi_cp_async16(reinterpret_cast<float4*>(s_acc) + k,
                    reinterpret_cast<const float4*>(accept) + k);
    gi_cp_commit();
    tb.rows = s_rows;
    tb.acc = s_acc;
    s_box = s_acc + t_pad;
  } else {
    tb.rows = featp;
    tb.acc = accept;
    s_box = reinterpret_cast<float*>(gi_smem);
  }
  for (int k = threadIdx.x; k < 6 * n_chunks; k += kThreads)
    s_box[k] = __ldg(cbox + k);  // rows 0-5 of the (8, n_chunks) table
  tb.box = s_box;
  gi_cp_wait<0>();
  __syncthreads();

  const float far = 1e30f;
  const V3 zero = v3(0.0f, 0.0f, 0.0f);
  int i = -1;  // the lane this thread's path belongs to
  int d = 0;
  uint32_t rid = 0u;
  V3 ro = zero, rd = zero, thr = zero, con = zero, rad = zero;
  bool drained = false;
  uint32_t tests_c = 0u, tests_s = 0u;

  for (;;) {
    // ---- free threads take the next lanes of the wave ----------------
    if (!drained) {
      const unsigned want = __ballot_sync(kFull, i < 0);
      if (want) {
        int base = 0;
        if (lane == 0) base = atomicAdd(queue, __popc(want));
        base = __shfl_sync(kFull, base, 0);
        if (base + __popc(want) >= n_rays) drained = true;
        if (i < 0) {
          const int j = base + __popc(want & ((1u << lane) - 1u));
          if (j < n_rays) {
            i = j;
            d = 0;
            rid = (uint32_t)rid_in[i];
            ro = v3(ro_in[3 * i], ro_in[3 * i + 1], ro_in[3 * i + 2]);
            rd = v3(rd_in[3 * i], rd_in[3 * i + 1], rd_in[3 * i + 2]);
            thr = v3(1.0f, 1.0f, 1.0f);  // throughput
            con = v3(1.0f, 1.0f, 1.0f);  // contrib (roulette weight)
            rad = zero;
          }
        }
      }
    }
    const bool live = i >= 0;
    if (!__any_sync(kFull, live)) break;
    const uint32_t salt = salt0 + (uint32_t)d * 31337u;

    // ---- closest hit + exact MT recompute from the winner's row ----
    const int pid = warp_walk<SMEM, false>(
        tb, walk_ray(ro, rd, GI_BIG), live, rid, salt, eps, all_opaque,
        tests_c);
    bool valid = false;
    float bu = 0.0f, bv = 0.0f, t_ex = 0.0f;
    const float* row = attr + (size_t)(pid < 0 ? 0 : pid) * kAttrW;
    if (pid >= 0) {
      const V3 v0 = v3(__ldg(row + 0), __ldg(row + 1), __ldg(row + 2));
      const V3 e1 = v3(__ldg(row + 3), __ldg(row + 4), __ldg(row + 5));
      const V3 e2 = v3(__ldg(row + 6), __ldg(row + 7), __ldg(row + 8));
      const V3 p = cross3(rd, e2);
      const float det = dot3(e1, p);
      bool ok = fabsf(det) >= eps;
      const float inv_det = ok ? 1.0f / det : 0.0f;
      const V3 tv = v3(ro.x - v0.x, ro.y - v0.y, ro.z - v0.z);
      bu = dot3(tv, p) * inv_det;
      const V3 q = cross3(tv, e1);
      bv = dot3(rd, q) * inv_det;
      t_ex = dot3(e2, q) * inv_det;
      ok = ok && (bu >= 0.0f) && (bu <= 1.0f) && (bv >= 0.0f) &&
           (bu + bv <= 1.0f) && (t_ex > 0.0f);
      valid = ok;
    }
    if (live && !valid) {  // miss: ambient, path ends
      rad.x += thr.x * amb_r;
      rad.y += thr.y * amb_g;
      rad.z += thr.z * amb_b;
      if (with_caustic)
        write_record(caustic + ((size_t)i * D + d) * 9, v3(far, far, far),
                     zero, zero);
      end_path(out, caustic, i, d, D, L, with_caustic, rad, d + 1, d);
      i = -1;
    }

    // ---- shading (shade_from_rows, triangle lanes) ----
    // ro + t * rd rounded as the staged path rounds it (no FMA): the
    // point keys the caustic estimate's k-nearest selection.  What the
    // shadow walks do not need is settled before them (the next ray, the
    // roulette weight, the roulette), so fewer registers stay live
    // across them.
    V3 pt = zero, fn = zero, col = zero, em = zero;
    float rough = 1.0f, boost = 1.0f;
    bool survive = true;
    if (valid) {
      pt = v3(__fadd_rn(ro.x, __fmul_rn(t_ex, rd.x)),
              __fadd_rn(ro.y, __fmul_rn(t_ex, rd.y)),
              __fadd_rn(ro.z, __fmul_rn(t_ex, rd.z)));
      const bool has_vn = __ldg(row + 27) > 0.5f;
      const float w0 = 1.0f - bu - bv;
      V3 n;
      float uu = 0.0f, vv = 0.0f;
      if (has_vn) {
        n = v3(w0 * __ldg(row + 9) + bu * __ldg(row + 12) +
                   bv * __ldg(row + 15),
               w0 * __ldg(row + 10) + bu * __ldg(row + 13) +
                   bv * __ldg(row + 16),
               w0 * __ldg(row + 11) + bu * __ldg(row + 14) +
                   bv * __ldg(row + 17));
        uu = w0 * __ldg(row + 18) + bu * __ldg(row + 20) +
             bv * __ldg(row + 22);
        vv = w0 * __ldg(row + 19) + bu * __ldg(row + 21) +
             bv * __ldg(row + 23);
      } else {
        n = v3(__ldg(row + 24), __ldg(row + 25), __ldg(row + 26));
      }
      rough = __ldg(row + 28);
      const float alpha = __ldg(row + 29);  // const/checker alpha == 1
      const float ior = __ldg(row + 30);
      col = tex_eval(row, 31, uu, vv);
      em = tex_eval(row, 45, uu, vv);

      // ---- secondary ray (shading.secondary_ray) ----
      const float u_op = decision_u(rid, 4u, salt);  // RAY_TYPE_OPACITY
      const float u_fs = decision_u(rid, 5u, salt);  // RAY_TYPE_FRESNEL
      const bool backface = dot3(n, rd) > 0.0f;
      fn = backface ? v3(-n.x, -n.y, -n.z) : n;
      const float r0b = (1.0f - ior) / (1.0f + ior);
      const float r0 = r0b * r0b;
      const V3 rf = reflect3(rd, fn);
      const float om = 1.0f - dot3(rf, fn);
      const float om2 = om * om;
      const float fs = r0 + (1.0f - r0) * (om2 * om2 * om);
      int typ = 2;
      if (rough < 0.001f) typ = 0;
      if (u_op > alpha) typ = (u_fs < fs) ? 0 : 1;

      V3 out_dir;
      if (typ == 1) {
        const float eta = backface ? ior : 1.0f / ior;
        const float dn = dot3(fn, rd);
        const float kk = 1.0f - eta * eta * (1.0f - dn * dn);
        if (kk < 1e-5f) {
          out_dir = rf;  // total internal reflection
        } else {
          const float s = eta * dn + sqrtf(fmaxf(kk, 0.0f));
          out_dir = v3(eta * rd.x - s * fn.x, eta * rd.y - s * fn.y,
                       eta * rd.z - s * fn.z);
        }
      } else if (typ == 0) {
        out_dir = rf;
      } else {
        const float sx = sx_all[(size_t)d * n_rays + i];
        const float sy = sy_all[(size_t)d * n_rays + i];
        if (rough < 0.9f) {
          const float inv_pow = 1.0f / (1.0f / fmaxf(rough, 1e-6f) + 1.0f);
          V3 ph = frame_apply(rf, cos_power_local(sx, sy, inv_pow));
          if (dot3(ph, fn) < 0.0f) ph = reflect3(ph, fn);
          out_dir = ph;
        } else {
          out_dir = frame_apply(fn, cos_power_local(sx, sy, 0.5f));
        }
      }
      const V3 nc = typ == 2 ? v3(0.5f * (con.x * col.x + col.x),
                                  0.5f * (con.y * col.y + col.y),
                                  0.5f * (con.z * col.z + col.z))
                             : v3(1.0f, 1.0f, 1.0f);
      const float offset_sign = typ == 1 ? -1.0f : 1.0f;

      // ---- Russian roulette ----
      const float u_rr = decision_u(rid, 3u, salt);  // RUSSIAN_ROULETTE
      const float q = fmaxf(nc.x, fmaxf(nc.y, nc.z));
      if (d > min_depth) {
        survive = u_rr < q;
        boost = 1.0f / fmaxf(q, 1e-12f);
      }
      con = nc;
      ro = v3(pt.x + offset_sign * shadow_bias * fn.x,
              pt.y + offset_sign * shadow_bias * fn.y,
              pt.z + offset_sign * shadow_bias * fn.z);
      rd = out_dir;
    }

    // ---- direct light (integrator._direct_light) ----
    V3 idir = zero;
    for (int li = 0; li < L; ++li) {
      const V3 so = v3(pt.x + shadow_bias * fn.x, pt.y + shadow_bias * fn.y,
                       pt.z + shadow_bias * fn.z);
      const float* lr = lights + li * 8;
      const V3 lp = v3(__ldg(lr + 0), __ldg(lr + 1), __ldg(lr + 2));
      const float lrad = __ldg(lr + 6);
      const float ux = decision_u(rid, 1u + 16u * li, salt);  // LIGHT_POINT_X
      const float uy = decision_u(rid, 2u + 16u * li, salt);  // LIGHT_POINT_Y
      const float zz = fminf(fmaxf(2.0f * uy - 1.0f, -1.0f), 1.0f);
      const float st = sqrtf(fmaxf(1.0f - zz * zz, 0.0f));
      const V3 lps = v3(lp.x + lrad * (st * cosf(2.0f * kPi * ux)),
                        lp.y + lrad * (st * sinf(2.0f * kPi * ux)),
                        lp.z + lrad * zz);
      const V3 ld = v3(lps.x - so.x, lps.y - so.y, lps.z - so.z);
      const float t_lim = sqrtf(dot3(ld, ld)) - shadow_bias;
      const uint32_t sh_salt = salt + 7919u * (uint32_t)(li + 1);
      const bool occ = warp_walk<SMEM, true>(
          tb, walk_ray(so, normalize3(ld), t_lim), valid, rid, sh_salt,
          eps, all_opaque, tests_s) >= 0;
      if (!valid || occ) continue;
      const V3 tol = v3(lp.x - pt.x, lp.y - pt.y, lp.z - pt.z);
      const V3 tn = normalize3(tol);
      const float dd = fmaxf(dot3(fn, tn), 0.0f);
      const float l_term = dd > 0.0f
          ? powf(dd, 1.0f / fmaxf(rough, 1e-12f)) : 0.0f;
      const float gain = l_term * (1.0f / (kPi * dot3(tol, tol)));
      idir.x += __ldg(lr + 3) * gain;
      idir.y += __ldg(lr + 4) * gain;
      idir.z += __ldg(lr + 5) * gain;
    }
    if (!valid) continue;

    // ---- accumulation ----
    rad.x += thr.x * col.x * idir.x;
    rad.y += thr.y * col.y * idir.y;
    rad.z += thr.z * col.z * idir.z;
    if (survive) {
      rad.x += thr.x * em.x;
      rad.y += thr.y * em.y;
      rad.z += thr.z * em.z;
    }
    if (with_caustic) {
      float* rec = caustic + ((size_t)i * D + d) * 9;
      if (d <= caustic_max_depth && survive)
        write_record(rec, pt, rd,
                     v3(thr.x * col.x, thr.y * col.y, thr.z * col.z));
      else
        write_record(rec, v3(far, far, far), zero, zero);
    }
    thr = v3(thr.x * col.x * boost, thr.y * col.y * boost,
             thr.z * col.z * boost);
    if (!survive || d + 1 == D) {
      end_path(out, caustic, i, d, D, L, with_caustic, rad, d + 1, d + 1);
      i = -1;
    } else {
      ++d;
    }
  }
  if (counts) {
    if (tests_c) atomicAdd(counts, (unsigned long long)tests_c);
    if (tests_s) atomicAdd(counts + 1, (unsigned long long)tests_s);
  }
}

template <bool SMEM>
int mega_attr(size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      gi_mega_kernel<SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gi_mega_kernel<SMEM>, kThreads, smem);
}

// whether the table of t_pad rows goes to shared memory (it fits a
// block's opt-in shared memory with the boxes)
bool mega_table_fits(int t_pad) {
  static int optin = -1;
  if (optin < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return mega_smem_bytes(t_pad, t_pad / GI_CHUNK, true) <= (size_t)optin;
}

}  // namespace

extern "C" int gi_mega_launch(
    const float* ro, const float* rd, const float* sx_all,
    const float* sy_all, const int32_t* rid, const float* attr,
    const float* featp, const float* accept, const float* cbox,
    const float* lights, int n_rays, int t_pad, int D, int L, uint32_t salt0,
    float eps, float shadow_bias, int min_depth, float amb_r, float amb_g,
    float amb_b, int all_opaque, int with_caustic, int caustic_max_depth,
    float* out, float* caustic, int* queue,
    unsigned long long* counts, cudaStream_t stream) {
  if (t_pad <= 0 || t_pad % GI_CHUNK) return (int)cudaErrorInvalidValue;
  const bool table = mega_table_fits(t_pad);
  const size_t smem = mega_smem_bytes(t_pad, t_pad / GI_CHUNK, table);
  int blocks = 0;
  int err = table ? mega_attr<true>(smem, &blocks)
                  : mega_attr<false>(smem, &blocks);
  if (err) return err;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long need = ((long long)n_rays + kThreads - 1) / kThreads;
  const int grid = (int)(need < (long long)blocks * n_sm
                             ? need : (long long)blocks * n_sm);
  err = (int)cudaMemsetAsync(queue, 0, sizeof(int), stream);
  if (!err && counts)
    err = (int)cudaMemsetAsync(counts, 0, 2 * sizeof(unsigned long long),
                               stream);
  if (err) return err;
#define GI_MEGA_ARGS                                                         \
  ro, rd, sx_all, sy_all, rid, attr, reinterpret_cast<const float4*>(featp), \
      accept, cbox, lights, n_rays, t_pad, D, L, salt0, eps, shadow_bias,    \
      min_depth, amb_r, amb_g, amb_b, all_opaque, with_caustic,              \
      caustic_max_depth, out, caustic, queue, counts
  if (table)
    gi_mega_kernel<true><<<grid, kThreads, smem, stream>>>(GI_MEGA_ARGS);
  else
    gi_mega_kernel<false><<<grid, kThreads, smem, stream>>>(GI_MEGA_ARGS);
#undef GI_MEGA_ARGS
  return (int)cudaGetLastError();
}

// resources of the kernel that a table of t_pad rows takes:
// out[0] resident blocks per SM, out[1] registers per thread, out[2] local
// (spill) bytes per thread, out[3] dynamic shared bytes per block, out[4]
// static shared bytes, out[5] 1 when the table is in shared memory,
// out[6] threads per block
extern "C" int gi_mega_info(int t_pad, int* out) {
  if (t_pad <= 0 || t_pad % GI_CHUNK) return (int)cudaErrorInvalidValue;
  const bool table = mega_table_fits(t_pad);
  const size_t smem = mega_smem_bytes(t_pad, t_pad / GI_CHUNK, table);
  int blocks = 0;
  int err = table ? mega_attr<true>(smem, &blocks)
                  : mega_attr<false>(smem, &blocks);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)(table ? cudaFuncGetAttributes(&attr, gi_mega_kernel<true>)
                    : cudaFuncGetAttributes(&attr, gi_mega_kernel<false>));
  if (err) return err;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)smem;
  out[4] = (int)attr.sharedSizeBytes;
  out[5] = table ? 1 : 0;
  out[6] = kThreads;
  return 0;
}
