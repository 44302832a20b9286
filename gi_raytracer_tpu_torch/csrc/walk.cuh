// The ordered, culled, compacted chunk walk shared by the two triangle
// traces: K2 (intersect.cu, groups of one 128-row chunk) and K4 (stream.cu,
// groups of sixteen chunks, the 2,048-row superchunks).
//
// A block owns a tile of GI_TILE consecutive rays, one thread per ray for
// the per-ray steps, and answers the whole closest-hit or any-hit query:
//
//   1. set-up: every ray's slab entry into every group box (against its own
//      t limit; culled = BIG; the boxes read from shared memory), reduced
//      to the tile's least entry per group (a warp reduction and a
//      shared-memory atomicMin), the entered groups compacted and
//      bitonic-sorted by (entry, index);
//   2. the ordered walk: before each visit the tile's cap is refreshed, the
//      largest min(best t, t limit) of its active rays (any hit: the
//      largest t limit of active rays still without a hit), and the walk
//      stops at the first group whose entry exceeds it;
//   3. in a visited group a ray needs the group when its own entry is not
//      culled and (closest hit) is at or before its best t, or (any hit) it
//      has no hit yet; it then needs each chunk of the group whose box it
//      enters below its t limit and (closest hit) at or before its best t,
//      best t as it stood when the visit began.  The (ray, chunk) pairs are
//      compacted by chunk (a ballot per chunk and a shared-memory prefix
//      sum); dead lanes never enter the list;
//   4. the chunks some ray needs are copied into shared memory with
//      cp.async, GI_STAGE chunks a stage, double-buffered: the copy of the
//      next stage (K2: the next group's chunk) overlaps the tests of this
//      one, and a buffer is written again only after its last copy was
//      waited for.  Every warp of the block takes pairs from the list; its 32
//      lanes test 32 rows of the pair's chunk at once, reading the rows
//      from shared memory (the chunk is stored as four planes of float4, so
//      neighbouring lanes read neighbouring 16-byte words);
//   5. each ray's best hit lives in shared memory as one 64-bit key, merged
//      with atomicMin: closest hit (t bits << 32 | prim), so the smaller t
//      and then the smaller prim id win (an accepted t is > 0, so its bits
//      order like the float); any hit (prim << 32 | t bits), the least
//      accepted row, which within a chunk is the first in order, so a warp
//      stops at its first accepted row.
//
// Per tile the walk reports the groups visited and the ray-triangle tests
// the walk needed: 128 for every (ray, chunk) pair, or for any hit the rows
// up to and including the chunk's first accepted row.  Neither depends on
// how the pairs are spread over the warps.  The plain version is
// cuda_intersect.walk_plain.
//
// gi_walk_tile is the walk of one tile.  Two templates launch it, both
// named gi_walk_kernel: gi_walk_kernel<GC>, K2's and K4's query of the
// caller's rays (intersect.cu, stream.cu), and gi_walk_kernel<GC, P>, which
// runs a policy P of its own around it (photon.cu: the photon pass's retry
// round, which walks its tile once a step of the round).

#pragma once

#include "common.cuh"

#define GI_CHUNK 128        // rows per chunk
#define GI_TILE 256         // rays per tile = threads per block
#define GI_WARPS (GI_TILE / 32)
#define GI_STAGE 2          // K4: chunks per stage buffer (two buffers)
#define GI_MAX_GROUPS 2048  // groups a tile can order
#define GI_SLAB_TINY 1e-12f
#define GI_NO_HIT (~0ull)

__device__ __forceinline__ float gi_safe_inv(float d) {
  if (fabsf(d) < GI_SLAB_TINY) d = d < 0.0f ? -GI_SLAB_TINY : GI_SLAB_TINY;
  return 1.0f / d;
}

// slab entry max(t_near, 0) of the ray into the box lo..hi, or GI_BIG when
// it misses the box or enters at or past t_eff (the plain version's
// slab_scores)
__device__ __forceinline__ float gi_slab(const float lo[3], const float hi[3],
                                         float ox, float oy, float oz,
                                         float ix, float iy, float iz,
                                         float t_eff) {
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
  float tn = -GI_BIG, tf = GI_BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ta = __fmul_rn(__fsub_rn(lo[a], o[a]), inv[a]);
    const float tb = __fmul_rn(__fsub_rn(hi[a], o[a]), inv[a]);
    tn = fmaxf(tn, fminf(ta, tb));
    tf = fminf(tf, fmaxf(ta, tb));
  }
  const float ent = fmaxf(tn, 0.0f);
  return (tf >= ent && ent < t_eff) ? ent : GI_BIG;
}

// gi_slab of box j of an (8, n) box table in device memory
__device__ __forceinline__ float gi_slab_score(const float* __restrict__ box,
                                               int n, int j, float ox,
                                               float oy, float oz, float ix,
                                               float iy, float iz,
                                               float t_eff) {
  const float lo[3] = {__ldg(box + j), __ldg(box + n + j),
                       __ldg(box + 2 * n + j)};
  const float hi[3] = {__ldg(box + 3 * n + j), __ldg(box + 4 * n + j),
                       __ldg(box + 5 * n + j)};
  return gi_slab(lo, hi, ox, oy, oz, ix, iy, iz, t_eff);
}

__device__ __forceinline__ void gi_cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void gi_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void gi_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dynamic shared memory of one block: the stage buffers (which the set-up
// reuses for its per-group entries), the rays, their keys, the sorted
// groups and the pair list
struct GiWalkSmem {
  int stage;                 // chunks per stage buffer
  float4* rows;              // [2][stage][4 planes][GI_CHUNK]
  float* acc;                // [2][stage][GI_CHUNK]
  float4* ray;               // [GI_TILE][2]: (o, t_eff), (d, ray id bits)
  unsigned long long* key;   // [GI_TILE]
  unsigned long long* order; // [pow2(n_groups)]: (entry bits << 32 | group)
  uint16_t* pair;            // [GI_TILE * GC]: ray << 4 | chunk in group
  uint32_t* ent;             // [n_groups], aliases rows (set-up only)
};

__host__ __device__ inline int gi_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// chunks per stage buffer: K2 has one chunk per group, so one
__host__ __device__ constexpr int gi_stage(int gc) {
  return gc == 1 ? 1 : GI_STAGE;
}

__host__ __device__ inline size_t gi_walk_smem_bytes(int gc, int n_groups) {
  return (size_t)2 * gi_stage(gc) * 4 * GI_CHUNK * 16 +
         (size_t)2 * gi_stage(gc) * GI_CHUNK * 4 + (size_t)GI_TILE * 32 +
         (size_t)GI_TILE * 8 + (size_t)gi_pow2(n_groups) * 8 +
         (((size_t)GI_TILE * gc * 2 + 15) & ~(size_t)15);
}

__device__ __forceinline__ GiWalkSmem gi_walk_smem(unsigned char* base,
                                                   int stage, int n_groups) {
  GiWalkSmem s;
  s.stage = stage;
  s.rows = reinterpret_cast<float4*>(base);
  s.acc = reinterpret_cast<float*>(s.rows + 2 * stage * 4 * GI_CHUNK);
  s.ray = reinterpret_cast<float4*>(s.acc + 2 * stage * GI_CHUNK);
  s.key = reinterpret_cast<unsigned long long*>(s.ray + 2 * GI_TILE);
  s.order = s.key + GI_TILE;
  s.pair = reinterpret_cast<uint16_t*>(s.order + gi_pow2(n_groups));
  s.ent = reinterpret_cast<uint32_t*>(base);
  return s;
}

// copy chunk c (128 feature rows, and its accept values unless the scene is
// all opaque) into stage slot `slot` of buffer `buf`, as four planes of
// float4 (plane q holds quad q of every row)
__device__ __forceinline__ void gi_load_chunk(const GiWalkSmem& s, int buf,
                                              int slot, int c,
                                              const float4* __restrict__ feat,
                                              const float* __restrict__ accept,
                                              bool with_accept) {
  float4* dst = s.rows + (buf * s.stage + slot) * 4 * GI_CHUNK;
  const float4* src = feat + (size_t)c * GI_CHUNK * 4;
  for (int k = threadIdx.x; k < GI_CHUNK * 4; k += GI_TILE)
    gi_cp_async16(dst + (k & 3) * GI_CHUNK + (k >> 2), src + k);
  if (with_accept) {
    float4* da = reinterpret_cast<float4*>(
        s.acc + (buf * s.stage + slot) * GI_CHUNK);
    const float4* sa =
        reinterpret_cast<const float4*>(accept + (size_t)c * GI_CHUNK);
    for (int k = threadIdx.x; k < GI_CHUNK / 4; k += GI_TILE)
      gi_cp_async16(da + k, sa + k);
  }
}

__device__ __forceinline__ float gi_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp tests one (ray, chunk) pair: the chunk's 128 rows from shared
// memory, 32 at a time.  Lane 0 merges the result into the ray's key and
// returns the tests the walk needed (the other lanes return 0).
__device__ __forceinline__ int gi_test_pair(const GiWalkSmem& s, int r,
                                            const float4* rows,
                                            const float* acc, int prim0,
                                            uint32_t salt, float eps,
                                            bool any_hit, bool all_opaque) {
  const int lane = threadIdx.x & 31;
  const float4 a = s.ray[2 * r], b = s.ray[2 * r + 1];
  const GiRay ray = gi_make_ray(a.x, a.y, a.z, b.x, b.y, b.z);
  const float t_eff = a.w;
  const uint32_t rid = __float_as_uint(b.w);
  unsigned long long best = GI_NO_HIT;
  int made = GI_CHUNK;
#pragma unroll 1
  for (int it = 0; it < GI_CHUNK / 32; ++it) {
    const int row = it * 32 + lane;
    const float tc = gi_tri_test4(ray, rows[row], rows[GI_CHUNK + row],
                                  rows[2 * GI_CHUNK + row],
                                  rows[3 * GI_CHUNK + row], eps);
    bool ok = tc >= 0.0f && tc < t_eff;
    if (ok && !all_opaque) {
      const float p = acc[row];
      ok = p >= 1.0f || gi_alpha_u01(rid, (uint32_t)(prim0 + row), salt) < p;
    }
    if (any_hit) {
      const unsigned hits = __ballot_sync(0xffffffffu, ok);
      if (hits) {
        const int first = __ffs(hits) - 1;
        const float t1 = __shfl_sync(0xffffffffu, tc, first);
        best = ((unsigned long long)(uint32_t)(prim0 + it * 32 + first)
                << 32) | __float_as_uint(t1);
        made = it * 32 + first + 1;
        break;
      }
    } else if (ok) {
      const unsigned long long k =
          ((unsigned long long)__float_as_uint(tc) << 32) |
          (uint32_t)(prim0 + row);
      best = k < best ? k : best;
    }
  }
  if (!any_hit) {
    const uint32_t hi =
        __reduce_min_sync(0xffffffffu, (uint32_t)(best >> 32));
    const uint32_t lo = __reduce_min_sync(
        0xffffffffu, (uint32_t)(best >> 32) == hi ? (uint32_t)best : ~0u);
    best = ((unsigned long long)hi << 32) | lo;
  }
  if (lane != 0) return 0;
  if (best != GI_NO_HIT) atomicMin(s.key + r, best);
  return made;
}

// The walk of one tile.  Every thread of the block calls it, with its own
// ray: `act` false for a thread without a query (past the rays, or
// inactive), whose ray then takes no part.  GC chunks per group: 1 for K2
// (a group is a chunk; gbox is the chunk boxes), 16 for K4 (superchunk
// boxes in gbox, chunk boxes in cbox).  n_chunks = t_pad / GI_CHUNK.
// Returns the thread's key (GI_NO_HIT: none); nv = the groups the tile
// visited, nt += the tests of the pairs this thread tested as lane 0 of its
// warp.  A block may call it again once every thread has returned (a
// barrier): the tile's shared memory is then written anew.
template <int GC>
__device__ __forceinline__ unsigned long long gi_walk_tile(
    const GiWalkSmem& s, const float4* __restrict__ feat,
    const float* __restrict__ accept, const float* __restrict__ gbox,
    const float* __restrict__ cbox, int n_groups, int n_chunks, bool act,
    float ox, float oy, float oz, float dx, float dy, float dz, float t_eff,
    uint32_t ray_id, uint32_t salt, float eps, bool any_hit, bool all_opaque,
    int& nv, int& nt) {
  __shared__ int s_wcnt[GI_WARPS][GC];  // per warp, then its offset
  __shared__ int s_cofs[GC + 1];        // pair list offset per chunk
  __shared__ int s_uidx[GC];            // chunk -> place among needed ones
  __shared__ int s_ulist[GC];           // needed chunks, ascending
  __shared__ int s_nu, s_n;
  __shared__ float s_wmax[GI_WARPS];

  constexpr int ST = gi_stage(GC);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float ix = gi_safe_inv(dx), iy = gi_safe_inv(dy), iz = gi_safe_inv(dz);
  const uint32_t big_bits = __float_as_uint(GI_BIG);
  s.ray[2 * tid] = make_float4(ox, oy, oz, t_eff);
  s.ray[2 * tid + 1] = make_float4(dx, dy, dz, __uint_as_float(ray_id));
  s.key[tid] = GI_NO_HIT;

  // ---- 1. the tile's least entry into each group, sorted -----------------
  // The group boxes pass through the stage buffers (after the entries) in
  // batches, so every warp reads them from shared memory; a tile without
  // a live ray skips the cull.
  for (int j = tid; j < n_groups; j += GI_TILE) s.ent[j] = big_bits;
  if (tid == 0) s_n = 0;
  const bool tile_live = __syncthreads_or(act);
  const bool warp_live = __any_sync(0xffffffffu, act);
  float* s_box = reinterpret_cast<float*>(s.rows) + GI_MAX_GROUPS;
  constexpr int BATCH = (ST * 2 * 4 * GI_CHUNK * 4 - GI_MAX_GROUPS) / 6;
  for (int g0 = 0; tile_live && g0 < n_groups; g0 += BATCH) {
    const int nb = min(BATCH, n_groups - g0);
    for (int k = tid; k < 6 * nb; k += GI_TILE) {
      const int a = k / nb;
      s_box[k] = __ldg(gbox + a * n_groups + g0 + (k - a * nb));
    }
    __syncthreads();
    if (warp_live) {
#pragma unroll 4
      for (int j = 0; j < nb; ++j) {
        const float lo[3] = {s_box[j], s_box[nb + j], s_box[2 * nb + j]};
        const float hi[3] = {s_box[3 * nb + j], s_box[4 * nb + j],
                             s_box[5 * nb + j]};
        const float e = gi_slab(lo, hi, ox, oy, oz, ix, iy, iz, t_eff);
        // entries are >= 0, so their bits order like the floats
        const uint32_t m =
            __reduce_min_sync(0xffffffffu, __float_as_uint(e));
        if (lane == 0 && m < big_bits) atomicMin(s.ent + g0 + j, m);
      }
    }
    __syncthreads();
  }
  for (int j = tid; j < n_groups; j += GI_TILE) {
    const uint32_t e = s.ent[j];
    if (e < big_bits)
      s.order[atomicAdd(&s_n, 1)] = ((unsigned long long)e << 32) | (uint32_t)j;
  }
  __syncthreads();
  const int n = s_n;
  const int P = gi_pow2(n);
  for (int j = n + tid; j < P; j += GI_TILE) s.order[j] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < P; t += GI_TILE) {
        const int u = t ^ j;
        if (u > t) {
          const unsigned long long x = s.order[t], y = s.order[u];
          if ((x > y) == ((t & k) == 0)) {
            s.order[t] = y;
            s.order[u] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- 2. the ordered walk -------------------------------------------------
  // K2: the first group's chunk is on its way while the cap is reduced
  if (GC == 1 && n > 0) {
    gi_load_chunk(s, 0, 0, (int)(uint32_t)s.order[0], feat, accept,
                  !all_opaque);
    gi_cp_commit();
  }
  float cap = GI_BIG;
  nv = 0;
  for (int v = 0;; ++v) {
    // the cap: every key is final here (the last barrier of the visit)
    const unsigned long long key = s.key[tid];
    const bool has = key != GI_NO_HIT;
    const float best_t = has ? __uint_as_float((uint32_t)(key >> 32)) : GI_BIG;
    const float need_t = any_hit ? (has ? -GI_BIG : t_eff)
                                 : fminf(best_t, t_eff);
    const float wm = gi_warp_max(need_t);
    if (lane == 0) s_wmax[warp] = wm;
    __syncthreads();
    float m = s_wmax[0];
    for (int w = 1; w < GI_WARPS; ++w) m = fmaxf(m, s_wmax[w]);
    cap = v == 0 ? m : fminf(cap, m);
    if (v >= n) break;
    const unsigned long long ok = s.order[v];
    if (__uint_as_float((uint32_t)(ok >> 32)) > cap) break;
    const int g = (int)(uint32_t)ok;
    ++nv;

    // which chunks of the group this ray needs
    uint32_t mask = 0u;
    if (act) {
      const float own = gi_slab_score(gbox, n_groups, g, ox, oy, oz, ix, iy,
                                      iz, t_eff);
      if (own < GI_BIG && (any_hit ? !has : own <= best_t)) {
        if (GC == 1) {
          mask = 1u;
        } else {
#pragma unroll 1
          for (int j = 0; j < GC; ++j) {
            const int c = g * GC + j;
            if (c >= n_chunks) break;
            const float e = gi_slab_score(cbox, n_chunks, c, ox, oy, oz, ix,
                                          iy, iz, t_eff);
            if (e < GI_BIG && (any_hit || e <= best_t)) mask |= 1u << j;
          }
        }
      }
    }
    // compact the (ray, chunk) pairs by chunk
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      const unsigned b = __ballot_sync(0xffffffffu, (mask >> j) & 1u);
      if (lane == 0) s_wcnt[warp][j] = __popc(b);
    }
    __syncthreads();
    if (warp == 0) {
      int total = 0;
      if (lane < GC) {
        for (int w = 0; w < GI_WARPS; ++w) {
          const int c = s_wcnt[w][lane];
          s_wcnt[w][lane] = total;
          total += c;
        }
      }
      int incl = total;  // inclusive prefix of the totals over the chunks
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const unsigned used = __ballot_sync(0xffffffffu, lane < GC && total);
      if (lane < GC) {
        s_cofs[lane + 1] = incl;
        if (total) {
          const int u = __popc(used & ((1u << lane) - 1u));
          s_uidx[lane] = u;
          s_ulist[u] = lane;
        }
      }
      if (lane == 0) s_cofs[0] = 0, s_nu = __popc(used);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      const bool bit = (mask >> j) & 1u;
      const unsigned b = __ballot_sync(0xffffffffu, bit);
      if (bit)
        s.pair[s_cofs[j] + s_wcnt[warp][j] + __popc(b & ((1u << lane) - 1u))] =
            (uint16_t)((tid << 4) | j);
    }
    const int nu = s_nu;

    // test the pairs, stage by stage, from shared memory
    if (GC == 1) {
      // the next group's chunk goes into the other buffer now.  That
      // buffer's last copy (visit v-1's chunk) may still be in flight when
      // visit v-1 needed no chunk and so waited for nothing, and cp.async
      // copies are ordered only by a wait: wait for every group but this
      // visit's own before the buffer is written again.
      if (v + 1 < n) {
        gi_cp_wait<1>();
        gi_load_chunk(s, (v + 1) & 1, 0, (int)(uint32_t)s.order[v + 1], feat,
                      accept, !all_opaque);
        gi_cp_commit();
      }
    } else if (nu > 0) {
      for (int q = 0; q < ST && q < nu; ++q)
        gi_load_chunk(s, 0, q, g * GC + s_ulist[q], feat, accept,
                      !all_opaque);
      gi_cp_commit();
    }
    const int n_stages = (nu + ST - 1) / ST;
    for (int st = 0; st < n_stages; ++st) {
      if (GC == 1) {
        if (v + 1 < n) gi_cp_wait<1>(); else gi_cp_wait<0>();
      } else if (st + 1 < n_stages) {
        const int q0 = (st + 1) * ST;
        for (int q = q0; q < q0 + ST && q < nu; ++q)
          gi_load_chunk(s, (st + 1) & 1, q - q0, g * GC + s_ulist[q], feat,
                        accept, !all_opaque);
        gi_cp_commit();
        gi_cp_wait<1>();
      } else {
        gi_cp_wait<0>();
      }
      __syncthreads();
      const int buf = GC == 1 ? (v & 1) : (st & 1);
      const int u0 = st * ST;
      const int u1 = min(u0 + ST, nu);
      const int p0 = s_cofs[s_ulist[u0]], p1 = s_cofs[s_ulist[u1 - 1] + 1];
      for (int k = p0 + warp; k < p1; k += GI_WARPS) {
        const int pr = s.pair[k];
        const int j = pr & 15;
        const int slot = s_uidx[j] - u0;
        const int c = g * GC + j;
        nt += gi_test_pair(s, pr >> 4,
                           s.rows + (buf * ST + slot) * 4 * GI_CHUNK,
                           s.acc + (buf * ST + slot) * GI_CHUNK,
                           c * GI_CHUNK, salt, eps, any_hit, all_opaque);
      }
      __syncthreads();
    }
  }
  gi_cp_wait<0>();  // a prefetch the walk did not use
  return s.key[tid];
}

// K2 and K4: the walk kernel's query, one ray a thread, read from the
// caller's arrays, and its closest or any hit written back with the tile's
// counts (visits and tests).
template <int GC>
__global__ void __launch_bounds__(GI_TILE, 4)
gi_walk_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
               const float* __restrict__ tlim,
               const uint8_t* __restrict__ active,
               const int32_t* __restrict__ rid,
               const float4* __restrict__ feat,
               const float* __restrict__ accept,
               const float* __restrict__ gbox, const float* __restrict__ cbox,
               int n_rays, int n_groups, int n_chunks, uint32_t salt,
               float eps, int any_hit_i, int all_opaque_i,
               float* __restrict__ out_t, int32_t* __restrict__ out_prim,
               int32_t* __restrict__ visits, int32_t* __restrict__ tests) {
  extern __shared__ __align__(16) unsigned char gi_smem[];
  __shared__ int s_tests;
  const GiWalkSmem s = gi_walk_smem(gi_smem, gi_stage(GC), n_groups);
  const bool any_hit = any_hit_i != 0, all_opaque = all_opaque_i != 0;
  const int tid = threadIdx.x, lane = tid & 31;
  const int i = blockIdx.x * GI_TILE + tid;
  const bool act = i < n_rays && active[i];
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  uint32_t ray_id = 0u;
  if (i < n_rays) {
    ox = ro[3 * i]; oy = ro[3 * i + 1]; oz = ro[3 * i + 2];
    dx = rd[3 * i]; dy = rd[3 * i + 1]; dz = rd[3 * i + 2];
    ray_id = (uint32_t)rid[i];
  }
  const float t_eff = act ? tlim[i] : -GI_BIG;
  if (tid == 0) s_tests = 0;  // the walk's barriers come before the adds
  int nv = 0, nt = 0;
  const unsigned long long key = gi_walk_tile<GC>(
      s, feat, accept, gbox, cbox, n_groups, n_chunks, act, ox, oy, oz, dx,
      dy, dz, t_eff, ray_id, salt, eps, any_hit, all_opaque, nv, nt);
  if (i < n_rays) {
    float t = GI_BIG;
    int32_t p = -1;
    if (key != GI_NO_HIT) {
      const uint32_t hi = (uint32_t)(key >> 32), lo = (uint32_t)key;
      t = __uint_as_float(any_hit ? lo : hi);
      p = (int32_t)(any_hit ? hi : lo);
    }
    out_t[i] = t;
    out_prim[i] = p;
  }
  nt = __reduce_add_sync(0xffffffffu, nt);
  if (lane == 0 && nt) atomicAdd(&s_tests, nt);
  __syncthreads();
  if (tid == 0) {
    visits[blockIdx.x] = nv;
    tests[blockIdx.x] = s_tests;
  }
}

// The walk kernel under a policy P of its own: a block of GI_TILE threads
// owns a tile and runs P::tile<GC> (P::Args a, the walk's shared memory),
// which calls gi_walk_tile as it needs; __launch_bounds__ with
// P::kMinBlocks blocks an SM.
template <int GC, class P>
__global__ void __launch_bounds__(GI_TILE, P::kMinBlocks)
gi_walk_kernel(const typename P::Args a) {
  extern __shared__ __align__(16) unsigned char gi_smem[];
  P::template tile<GC>(a, gi_walk_smem(gi_smem, gi_stage(GC), a.n_groups));
}

// the query kernel's type, which picks it among the two templates
using GiQueryKernel = void (*)(const float*, const float*, const float*,
                               const uint8_t*, const int32_t*, const float4*,
                               const float*, const float*, const float*, int,
                               int, int, uint32_t, float, int, int, float*,
                               int32_t*, int32_t*, int32_t*);

// the entry of the walk kernel: the query (P void) or policy P's
template <int GC, class P>
struct GiWalkEntry {
  static auto fn() { return gi_walk_kernel<GC, P>; }
};
template <int GC>
struct GiWalkEntry<GC, void> {
  static GiQueryKernel fn() { return gi_walk_kernel<GC>; }
};

// the walk kernel's dynamic shared memory at n_groups, set as its limit
template <int GC, class P>
inline cudaError_t gi_walk_smem_limit(int n_groups, size_t* smem) {
  *smem = gi_walk_smem_bytes(GC, n_groups);
  return cudaFuncSetAttribute(GiWalkEntry<GC, P>::fn(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

// launch the query walk on `stream`; returns cudaGetLastError()
template <int GC>
inline int gi_walk_launch(const float* ro, const float* rd, const float* tlim,
                          const uint8_t* active, const int32_t* rid,
                          const float* feat, const float* accept,
                          const float* gbox, const float* cbox, int n_rays,
                          int n_groups, int n_chunks, uint32_t salt,
                          float eps, int any_hit, int all_opaque,
                          float* out_t, int32_t* out_prim, int32_t* visits,
                          int32_t* tests, cudaStream_t stream) {
  if (n_groups > GI_MAX_GROUPS || n_groups < 0 || n_chunks < 0)
    return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err = gi_walk_smem_limit<GC, void>(n_groups, &smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_rays + GI_TILE - 1) / GI_TILE;
  gi_walk_kernel<GC><<<grid, GI_TILE, smem, stream>>>(
      ro, rd, tlim, active, rid, reinterpret_cast<const float4*>(feat), accept,
      gbox, cbox, n_rays, n_groups, n_chunks, salt, eps, any_hit, all_opaque,
      out_t, out_prim, visits, tests);
  return (int)cudaGetLastError();
}

// launch policy P's walk kernel on `grid` tiles of a.n_groups groups;
// returns cudaGetLastError()
template <int GC, class P>
inline int gi_walk_run(const typename P::Args& a, int grid,
                       cudaStream_t stream) {
  size_t smem;
  cudaError_t err = gi_walk_smem_limit<GC, P>(a.n_groups, &smem);
  if (err != cudaSuccess) return (int)err;
  if (grid > 0) gi_walk_kernel<GC, P><<<grid, GI_TILE, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// resources of the walk kernel (the query, P void; or policy P's) at
// n_groups: out[0] resident blocks per SM, out[1] registers per thread,
// out[2] local (spill) bytes per thread, out[3] dynamic shared bytes per
// block, out[4] static shared bytes
template <int GC, class P = void>
inline int gi_walk_info(int n_groups, int* out) {
  size_t smem;
  cudaError_t err = gi_walk_smem_limit<GC, P>(n_groups, &smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, GiWalkEntry<GC, P>::fn(), GI_TILE, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, GiWalkEntry<GC, P>::fn());
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)smem;
  out[4] = (int)attr.sharedSizeBytes;
  return 0;
}
