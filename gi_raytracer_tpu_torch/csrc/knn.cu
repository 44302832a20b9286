// K3: kNN caustic estimate over the photon grid.
//
// Replaces gi_raytracer_tpu/render/photon_knn.py::_tile_kernel_small and
// _tile_kernel_large (launched by _tile_blocks).  The TPU kernels serve
// Morton tiles of 64 (or 16) queries whose window union was fetched as
// 32-photon chunk rows, mask candidates by cell membership, and find the
// exact k-th squared distance by a 32-step bisection on the float bits.
// That tile machinery exists for the TPU's gather costs and stays behind;
// the bisection stays.  Here one warp answers one query:
//
//   1. lanes 0-26 take one window cell each (ox, oy, oz order) and read its
//      photon range from cell_start; a warp scan of the takes
//      min(count, window_cap) turns the window into one flat candidate
//      range, candidate m being photon cell_start[c] + (m - offset[c]) of
//      the cell c whose offsets hold it (a binary search over the 27
//      offsets in shared memory);
//   2. lanes stride over the candidates (m = lane + 32 t) and compute d^2
//      (gi_d2, no FMA); the first GI_KNN_REG candidates of each lane keep
//      their d^2 bits and photon index in registers, the rest are read
//      again from the photon arrays when needed;
//   3. r_k^2 is the rank-th smallest d^2, rank = min(k, found): a
//      bisection on the float bits between the window's least and largest
//      d^2, counting d^2 <= mid over the warp with a reduction (skipped
//      when found <= k: then r_k^2 is the largest d^2);
//   4. the weighted sum over every candidate with d^2 <= r_k^2 is a warp
//      reduction; lane 0 writes the estimate.
//
// Per query (photon.py:490-573 semantics):
//   cell = clamp(trunc((p - grid_min) * inv_cell), 0, dims - 1);
//   27 cells, skipping duplicates at the clamp edge, at most window_cap
//   photons per cell (the first ones in cell order);
//   r_k^2 = the k-th smallest d^2 when more than k photons were found
//   (every d^2 <= r_k^2 counts, ties included), else the largest d^2;
//   est = sum col * (dir . qdir) / (pi * max(r_k^2, 1e-20)) / p,
//   p = got / true (the per-cell cap's subsample correction);
//   0 for an empty window or a far-sentinel query (x >= 1e29).
// Only the order of the sum differs from the plain version's.
//
// What bounds it on the card: the gathers of the window's photons
// (positions, then directions and colours of those within r_k) and
// their latency; a warp per query spreads a window over 32 lanes, so a
// query costs about its candidates / 32 dependent loads instead of all of
// them, and ragged windows no longer diverge a warp.

#include "common.cuh"

#define GI_KNN_KMAX 64
#define GI_KNN_WARPS 8     // queries per block of 256 threads
#define GI_KNN_REG 4       // candidates a lane keeps in registers

namespace {

constexpr unsigned kFull = 0xffffffffu;

// (dx*dx + dy*dy) + dz*dz without FMA contraction: the same bits as the
// plain version, so both pick the same k nearest photons
__device__ __forceinline__ float gi_d2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ int gi_cell(float p, float g, float inv, int n) {
  float v = (p - g) * inv;
  v = fminf(fmaxf(v, -1.0f), (float)n);  // saturate before the int cast
  int c = (int)v;                        // truncation toward zero
  return min(max(c, 0), n - 1);
}

// photon index of window candidate m (offsets: the warp's 28 exclusive
// prefix sums of the takes, begins: the cells' first photons)
__device__ __forceinline__ int candidate(const int* off, const int* beg,
                                         int m) {
  int c = 0;
#pragma unroll
  for (int step = 16; step; step >>= 1)
    if (c + step < 27 && off[c + step] <= m) c += step;
  return beg[c] + (m - off[c]);
}

// d^2 bits of candidate photon j, or ~0 for an invalid slot (above every
// d^2; d^2 >= 0, so its bits order like the float)
__device__ __forceinline__ uint32_t d2_bits(const float* __restrict__ ppos,
                                            const uint8_t* __restrict__ pvalid,
                                            int j, float qx, float qy,
                                            float qz) {
  if (!__ldg(pvalid + j)) return ~0u;
  const float dx = __ldg(ppos + 3 * j) - qx;
  const float dy = __ldg(ppos + 3 * j + 1) - qy;
  const float dz = __ldg(ppos + 3 * j + 2) - qz;
  return __float_as_uint(gi_d2(dx, dy, dz));
}

}  // namespace

__global__ void __launch_bounds__(32 * GI_KNN_WARPS)
gi_knn_kernel(const float* __restrict__ qpos, const float* __restrict__ qdir,
              int n_q, const float* __restrict__ ppos,
              const float* __restrict__ pdir, const float* __restrict__ pcol,
              const uint8_t* __restrict__ pvalid,
              const int32_t* __restrict__ cell_start, int nx, int ny, int nz,
              float gx, float gy, float gz, float ix, float iy, float iz,
              int window_cap, int k, float* __restrict__ out) {
  __shared__ int s_off[GI_KNN_WARPS][28];
  __shared__ int s_beg[GI_KNN_WARPS][27];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * GI_KNN_WARPS + w;
  if (i >= n_q) return;  // the whole warp
  const float qx = qpos[3 * i], qy = qpos[3 * i + 1], qz = qpos[3 * i + 2];
  float* o = out + 3 * i;
  if (!(qx < 1e29f)) {
    if (lane < 3) o[lane] = 0.0f;
    return;
  }
  const int cx = gi_cell(qx, gx, ix, nx);
  const int cy = gi_cell(qy, gy, iy, ny);
  const int cz = gi_cell(qz, gz, iz, nz);

  // ---- 1. the window's cells, as one candidate range -------------------
  int beg = 0, cnt = 0;
  if (lane < 27) {
    const int wx = cx + lane / 9 - 1;
    const int wy = cy + (lane / 3) % 3 - 1;
    const int wz = cz + lane % 3 - 1;
    // clamp-edge duplicates take nothing
    if (wx >= 0 && wx < nx && wy >= 0 && wy < ny && wz >= 0 && wz < nz) {
      const int cid = (wx * ny + wy) * nz + wz;
      beg = __ldg(cell_start + cid);
      cnt = __ldg(cell_start + cid + 1) - beg;
    }
  }
  const int take = min(cnt, window_cap);
  int incl = take;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int n_got = __shfl_sync(kFull, incl, 31);
  const int n_true = __reduce_add_sync(kFull, cnt);
  if (lane < 27) {
    s_off[w][lane] = incl - take;
    s_beg[w][lane] = beg;
  }
  __syncwarp();
  const int* off = s_off[w];
  const int* begs = s_beg[w];

  // ---- 2. d^2 of every candidate ----------------------------------------
  uint32_t dreg[GI_KNN_REG];
  int jreg[GI_KNN_REG];
  uint32_t lo = ~0u, hi = 0u;
  int found = 0;
#pragma unroll
  for (int t = 0; t < GI_KNN_REG; ++t) {
    const int m = lane + 32 * t;
    dreg[t] = ~0u;
    jreg[t] = 0;
    if (m < n_got) {
      jreg[t] = candidate(off, begs, m);
      dreg[t] = d2_bits(ppos, pvalid, jreg[t], qx, qy, qz);
    }
  }
  for (int m = lane + 32 * GI_KNN_REG; m < n_got; m += 32) {
    const uint32_t b = d2_bits(ppos, pvalid, candidate(off, begs, m), qx, qy,
                               qz);
    if (b != ~0u) {
      ++found;
      lo = min(lo, b);
      hi = max(hi, b);
    }
  }
#pragma unroll
  for (int t = 0; t < GI_KNN_REG; ++t) {
    if (dreg[t] != ~0u) {
      ++found;
      lo = min(lo, dreg[t]);
      hi = max(hi, dreg[t]);
    }
  }
  found = __reduce_add_sync(kFull, found);
  if (found == 0) {
    if (lane < 3) o[lane] = 0.0f;
    return;
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);

  // ---- 3. r_k^2: the rank-th smallest d^2, by bisection on the bits -----
  if (found > k) {
    while (lo < hi) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      int c = 0;
#pragma unroll
      for (int t = 0; t < GI_KNN_REG; ++t) c += dreg[t] <= mid;
      for (int m = lane + 32 * GI_KNN_REG; m < n_got; m += 32)
        c += d2_bits(ppos, pvalid, candidate(off, begs, m), qx, qy, qz) <=
             mid;
      if (__reduce_add_sync(kFull, c) >= k) hi = mid;
      else lo = mid + 1;
    }
  }
  const uint32_t rk_bits = hi;  // found <= k: the largest d^2

  // ---- 4. weighted sum over every photon within r_k (ties included) -----
  const float qdx = qdir[3 * i], qdy = qdir[3 * i + 1], qdz = qdir[3 * i + 2];
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  auto add = [&](int j) {
    const float wgt = __ldg(pdir + 3 * j) * qdx + __ldg(pdir + 3 * j + 1) * qdy +
                      __ldg(pdir + 3 * j + 2) * qdz;
    sr += __ldg(pcol + 3 * j) * wgt;
    sg += __ldg(pcol + 3 * j + 1) * wgt;
    sb += __ldg(pcol + 3 * j + 2) * wgt;
  };
#pragma unroll
  for (int t = 0; t < GI_KNN_REG; ++t)
    if (dreg[t] <= rk_bits) add(jreg[t]);
  for (int m = lane + 32 * GI_KNN_REG; m < n_got; m += 32) {
    const int j = candidate(off, begs, m);
    if (d2_bits(ppos, pvalid, j, qx, qy, qz) <= rk_bits) add(j);
  }
  for (int d = 16; d > 0; d >>= 1) {
    sr += __shfl_xor_sync(kFull, sr, d);
    sg += __shfl_xor_sync(kFull, sg, d);
    sb += __shfl_xor_sync(kFull, sb, d);
  }
  if (lane == 0) {
    const float rk2 = __uint_as_float(rk_bits);
    const float p_rate = n_true > 0 ? (float)n_got / (float)max(n_true, 1)
                                    : 1.0f;
    const float scale = 1.0f / (GI_PI * fmaxf(rk2, 1e-20f)) /
                        fmaxf(p_rate, 1e-6f);
    o[0] = sr * scale;
    o[1] = sg * scale;
    o[2] = sb * scale;
  }
}

extern "C" int gi_knn_launch(const float* qpos, const float* qdir, int n_q,
                             const float* ppos, const float* pdir,
                             const float* pcol, const uint8_t* pvalid,
                             const int32_t* cell_start, int nx, int ny,
                             int nz, float gx, float gy, float gz, float ix,
                             float iy, float iz, int window_cap, int k,
                             float* out, cudaStream_t stream) {
  if (k < 1 || k > GI_KNN_KMAX) return (int)cudaErrorInvalidValue;
  const int grid = (n_q + GI_KNN_WARPS - 1) / GI_KNN_WARPS;
  gi_knn_kernel<<<grid, 32 * GI_KNN_WARPS, 0, stream>>>(
      qpos, qdir, n_q, ppos, pdir, pcol, pvalid, cell_start, nx, ny, nz, gx,
      gy, gz, ix, iy, iz, window_cap, k, out);
  return (int)cudaGetLastError();
}

// resources of the kNN kernel: out[0] resident blocks per SM, out[1]
// registers per thread, out[2] local (spill) bytes per thread, out[3]
// dynamic shared bytes per block, out[4] static shared bytes, out[5]
// threads per block, out[6] candidates a warp keeps in registers
extern "C" int gi_knn_info(int* out) {
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gi_knn_kernel, 32 * GI_KNN_WARPS, 0);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gi_knn_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = 0;
  out[4] = (int)attr.sharedSizeBytes;
  out[5] = 32 * GI_KNN_WARPS;
  out[6] = 32 * GI_KNN_REG;
  return 0;
}
