// K4: the superchunk trace, closest hit / any hit for big triangle scenes.
//
// Replaces gi_raytracer_tpu/ops/pallas_intersect.py:388 _stream_kernel
// (launched by _stream_trace for scenes past VMEM_TRI_CAP = 16,384
// triangles).  The TPU kernel keeps the triangles in HBM as 2,048-triangle
// superchunks, culls them per ray outside the kernel, and DMAs them into
// VMEM in ascending entry order behind a collective t cap.  Here one block
// of 256 threads owns one tile of 256 consecutive rays (one thread, one
// ray) and does the whole query:
//
//   1. every thread computes its ray's slab entry into every superchunk box
//      against its own t limit; a warp reduction and a shared-memory
//      atomicMin give the tile's least entry per superchunk;
//   2. the superchunks entered are compacted and sorted by (entry, index)
//      with a bitonic sort in shared memory (at most MAX_SC = 2,048, 24 KB);
//   3. the tile walks them in that order and stops at the first whose entry
//      exceeds its cap: the largest min(best t, t limit) of its active rays
//      (any hit: the largest t limit of rays still without a hit), refreshed
//      by a block reduction after each visit.  In a visited superchunk a
//      thread skips the test when its own entry is culled or beyond its best
//      t; otherwise it reads the 2,048 feature rows in order, the whole warp
//      the same 64-byte row at once, as K2 does.
//
// Per tile it writes how many superchunks it visited and how many
// ray-triangle tests its threads made (the skips above and any hit's early
// exit left out).
//
// What bounds it on the card: FP32 arithmetic, ~41 operations per
// ray-triangle test, in the superchunks the tiles visit (the per-tile test
// counter reports them); the bytes are small beside that (a 1M-triangle
// table is 64 MB, read once per visit, mostly from L2).  The design's
// answer is to test less: the cull and the ordered walk with its early exit
// replace K2's walk over every triangle.  Staging superchunks in shared
// memory with cp.async/TMA and warp-level ray compaction are later work.
//
// Semantics match the plain version (cuda_stream.prim_query_stream_plain):
// the same cull, order, caps, per-ray skip, accept test and tie rule
// (tc < best, or equal tc and a smaller prim id); any hit takes the first
// accepted triangle in visit order.  Inactive lanes return (BIG, -1).

#include "common.cuh"

#define GI_SC_TRIS 2048
#define GI_TILE 256
#define GI_MAX_SC 2048
#define GI_SLAB_TINY 1e-12f

__device__ __forceinline__ float gi_block_max(float v, float* s_red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // s_red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) s_red[warp] = v;
  __syncthreads();
  float r = s_red[0];
  for (int w = 1; w < GI_TILE / 32; ++w) r = fmaxf(r, s_red[w]);
  return r;
}

// slab entry max(t_near, 0) of the ray into box sc, or GI_BIG when it misses
// the box or enters at or past t_eff (the plain version's slab_scores)
__device__ __forceinline__ float gi_slab_score(const float* __restrict__ box,
                                               int n_sc, int sc, float ox,
                                               float oy, float oz, float ix,
                                               float iy, float iz,
                                               float t_eff) {
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
  float tn = -GI_BIG, tf = GI_BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo = __ldg(box + a * n_sc + sc);
    const float hi = __ldg(box + (3 + a) * n_sc + sc);
    const float ta = __fmul_rn(__fsub_rn(lo, o[a]), inv[a]);
    const float tb = __fmul_rn(__fsub_rn(hi, o[a]), inv[a]);
    tn = fmaxf(tn, fminf(ta, tb));
    tf = fminf(tf, fmaxf(ta, tb));
  }
  const float ent = fmaxf(tn, 0.0f);
  return (tf >= ent && ent < t_eff) ? ent : GI_BIG;
}

__device__ __forceinline__ float gi_safe_inv(float d) {
  if (fabsf(d) < GI_SLAB_TINY) d = d < 0.0f ? -GI_SLAB_TINY : GI_SLAB_TINY;
  return 1.0f / d;
}

__global__ void __launch_bounds__(GI_TILE)
gi_stream_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ tlim,
                 const uint8_t* __restrict__ active,
                 const int32_t* __restrict__ rid,
                 const float* __restrict__ feat,
                 const float* __restrict__ accept,
                 const float* __restrict__ scbox, int n_rays, int t_pad,
                 int n_sc, uint32_t salt, float eps, int any_hit,
                 int all_opaque, float* __restrict__ out_t,
                 int32_t* __restrict__ out_prim, int32_t* __restrict__ visits,
                 int32_t* __restrict__ tests) {
  __shared__ uint32_t s_ent[GI_MAX_SC];             // entry bits per superchunk
  __shared__ unsigned long long s_key[GI_MAX_SC];   // (entry bits, index)
  __shared__ float s_red[GI_TILE / 32];
  __shared__ int s_n, s_tests;

  const int tid = threadIdx.x;
  const int i = blockIdx.x * GI_TILE + tid;
  const bool act = i < n_rays && active[i];
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (i < n_rays) {
    ox = ro[3 * i]; oy = ro[3 * i + 1]; oz = ro[3 * i + 2];
    dx = rd[3 * i]; dy = rd[3 * i + 1]; dz = rd[3 * i + 2];
  }
  const float t_eff = act ? tlim[i] : -GI_BIG;
  const float ix = gi_safe_inv(dx), iy = gi_safe_inv(dy), iz = gi_safe_inv(dz);
  const uint32_t big_bits = __float_as_uint(GI_BIG);

  // ---- 1. the tile's least entry into each superchunk ----------------------
  for (int j = tid; j < n_sc; j += GI_TILE) s_ent[j] = big_bits;
  if (tid == 0) s_n = 0, s_tests = 0;
  __syncthreads();
  for (int sc = 0; sc < n_sc; ++sc) {
    const float s = gi_slab_score(scbox, n_sc, sc, ox, oy, oz, ix, iy, iz,
                                  t_eff);
    // entries are >= 0, so their bits order like the floats
    const uint32_t m = __reduce_min_sync(0xffffffffu, __float_as_uint(s));
    if ((tid & 31) == 0 && m < big_bits) atomicMin(&s_ent[sc], m);
  }
  __syncthreads();

  // ---- 2. compact the entered superchunks and sort them by (entry, index) --
  for (int j = tid; j < n_sc; j += GI_TILE) {
    const uint32_t e = s_ent[j];
    if (e < big_bits) {
      const int k = atomicAdd(&s_n, 1);
      s_key[k] = ((unsigned long long)e << 32) | (uint32_t)j;
    }
  }
  __syncthreads();
  const int n = s_n;
  int P = 1;
  while (P < n) P <<= 1;
  for (int j = n + tid; j < P; j += GI_TILE) s_key[j] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < P; t += GI_TILE) {
        const int u = t ^ j;
        if (u > t) {
          const unsigned long long a = s_key[t], b = s_key[u];
          if ((a > b) == ((t & k) == 0)) {
            s_key[t] = b;
            s_key[u] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- 3. the ordered walk with the collective cap --------------------------
  const GiRay r = gi_make_ray(ox, oy, oz, dx, dy, dz);
  const uint32_t ray = i < n_rays ? (uint32_t)rid[i] : 0u;
  const float4* f4 = reinterpret_cast<const float4*>(feat);
  float best_t = GI_BIG;
  int best_p = -1;
  float cap = gi_block_max(t_eff, s_red);
  int nv = 0, nt = 0;
  for (int v = 0; v < n; ++v) {
    const unsigned long long key = s_key[v];
    if (__uint_as_float((uint32_t)(key >> 32)) > cap) break;
    const int sc = (int)(key & 0xffffffffu);
    ++nv;
    const float own = gi_slab_score(scbox, n_sc, sc, ox, oy, oz, ix, iy, iz,
                                    t_eff);
    const bool need = own < GI_BIG && (any_hit ? best_p < 0 : own <= best_t);
    if (need) {
      const int p1 = min(sc * GI_SC_TRIS + GI_SC_TRIS, t_pad);
      for (int p = sc * GI_SC_TRIS; p < p1; ++p) {
        ++nt;
        const float tc = gi_tri_test(r, f4 + 4 * p, eps);
        if (!(tc >= 0.0f) || !(tc < t_eff)) continue;
        if (!all_opaque) {
          const float acc = __ldg(accept + p);
          if (!(acc >= 1.0f) && !(gi_alpha_u01(ray, (uint32_t)p, salt) < acc))
            continue;
        }
        if (any_hit) {
          best_t = tc;
          best_p = p;
          break;
        }
        if (tc < best_t || (tc == best_t && p < best_p)) {
          best_t = tc;
          best_p = p;
        }
      }
    }
    const float need_t = any_hit ? (best_p < 0 ? t_eff : -GI_BIG)
                                 : fminf(best_t, t_eff);
    cap = fminf(cap, gi_block_max(need_t, s_red));
  }
  if (i < n_rays) {
    out_t[i] = best_t;
    out_prim[i] = best_p;
  }
  nt = __reduce_add_sync(0xffffffffu, nt);
  if ((tid & 31) == 0) atomicAdd(&s_tests, nt);
  __syncthreads();
  if (tid == 0) {
    visits[blockIdx.x] = nv;
    tests[blockIdx.x] = s_tests;
  }
}

extern "C" int gi_stream_launch(const float* ro, const float* rd,
                                const float* tlim, const uint8_t* active,
                                const int32_t* rid, const float* feat,
                                const float* accept, const float* scbox,
                                int n_rays, int t_pad, int n_sc, uint32_t salt,
                                float eps, int any_hit, int all_opaque,
                                float* out_t, int32_t* out_prim,
                                int32_t* visits, int32_t* tests,
                                cudaStream_t stream) {
  if (n_sc > GI_MAX_SC) return (int)cudaErrorInvalidValue;
  const int grid = (n_rays + GI_TILE - 1) / GI_TILE;
  gi_stream_kernel<<<grid, GI_TILE, 0, stream>>>(
      ro, rd, tlim, active, rid, feat, accept, scbox, n_rays, t_pad, n_sc,
      salt, eps, any_hit, all_opaque, out_t, out_prim, visits, tests);
  return (int)cudaGetLastError();
}
