// K3: kNN caustic estimate over the photon grid.
//
// Replaces gi_raytracer_tpu/render/photon_knn.py::_tile_kernel_small and
// _tile_kernel_large (launched by _tile_blocks) and _knn_kernel.  The TPU
// kernels serve Morton tiles of 64 (or 16) queries whose window union was
// fetched as 32-photon chunk rows, mask candidates by cell membership, and
// find the exact k-th squared distance by a 32-step bisection on the float
// bits.  That tile machinery exists for the TPU's gather costs and stays
// behind; the exact k-th distance on the float bits stays.  Here one warp
// answers one query:
//
//   1. lanes 0-26 take one window cell each (ox, oy, oz order) and read its
//      photon range from cell_start; a warp scan of the counts turns the
//      window into one flat candidate range, candidate m being photon
//      cell_start[c] + (m - offset[c]) of the cell c whose offsets hold it
//      (a binary search over the 27 offsets in shared memory; past the
//      registers a lane's m only grows within a pass, so it walks the
//      offsets forward from there: Cursor);
//   2. lanes stride over the candidates (m = lane + 32 t) and compute d^2
//      (gi_d2, no FMA); the first GI_KNN_REG candidates of each lane keep
//      their d^2 bits and photon index in registers, the rest are read
//      again from the photon arrays when needed, GI_KNN_UNROLL at a time a
//      lane, so that their gathers are in flight together;
//   3. r_k^2 is the rank-th smallest d^2, rank = min(k, found) (when
//      found <= k, the largest d^2): for a window held in registers, a
//      bisection on the float bits counting d^2 <= mid over the warp; for
//      a window past them, a radix select on the bits, 8 at a time from
//      the top (each pass counts the candidates that match the digits
//      found so far into 256 shared-memory bins and keeps the bin that
//      holds the rank), the matching candidates staged in shared memory
//      once at most GI_KNN_STAGE remain, so a window is read at most four
//      more times, and usually twice, instead of once a bisection step;
//   4. the weighted sum over every candidate with d^2 <= r_k^2 is a warp
//      reduction; lane 0 writes the estimate.
//
// Per query (the TPU kernels' estimator, photon_knn.py:71-139,652-760):
//   cell = clamp(trunc((p - grid_min) * inv_cell), 0, dims - 1);
//   27 cells, skipping duplicates at the clamp edge; every valid photon of
//   them is a candidate (no per-cell cap);
//   r_k^2 = the k-th smallest d^2 when more than k photons were found
//   (every d^2 <= r_k^2 counts, ties included), else the largest d^2;
//   est = sum col * (dir . qdir) / (pi * max(r_k^2, 1e-20));
//   0 for an empty window or a far-sentinel query (x >= 1e29).
// Only the order of the sum, and exact ties, differ from the plain version.
//
// What bounds it on the card: the gathers of the window's photons
// (positions, then directions and colours of those within r_k) and
// their latency; a warp per query spreads a window over 32 lanes, so a
// query costs about its candidates / 32 loads instead of all of them, and
// ragged windows no longer diverge a warp.  A focal window of thousands of
// candidates (a caustic's focus: 19,704 on the Cornell map's wave 0)
// paces the launch.  A 32-step bisection read such a window 32 times;
// when the focus is nearly a point, many candidates share the k-th
// distance's leading bits, so a bracket of them stays too large to stage
// until late; the radix select's four passes do not depend on that, and
// the unrolled walk keeps four candidates of a lane (their searches and
// gathers) in flight.

#include "common.cuh"

#define GI_KNN_KMAX 64
#define GI_KNN_WARPS 8     // queries per block of 256 threads
#define GI_KNN_REG 4       // candidates a lane keeps in registers
#define GI_KNN_STAGE 512   // d^2 bits a warp stages in shared memory
#define GI_KNN_UNROLL 4    // spilled candidates a lane gathers at once

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

// the window cell holding candidate m (offsets: the warp's 27 exclusive
// prefix sums of the cells' counts), by binary search
__device__ __forceinline__ int cell_of(const int* off, int m) {
  int c = 0;
#pragma unroll
  for (int step = 16; step; step >>= 1)
    if (c + step < 27 && off[c + step] <= m) c += step;
  return c;
}

// photon index of window candidate m (begins: the cells' first photons)
__device__ __forceinline__ int candidate(const int* off, const int* beg,
                                         int m) {
  const int c = cell_of(off, m);
  return beg[c] + (m - off[c]);
}

// a lane's walk over its candidates m past the registers: within one pass
// a lane's m only grows, so after one search the cell holding it moves
// forward instead of being searched for again
struct Cursor {
  int c = -1;
  __device__ __forceinline__ int photon(const int* off, const int* beg,
                                        int m) {
    if (c < 0) c = cell_of(off, m);
    while (c < 26 && off[c + 1] <= m) ++c;
    return beg[c] + (m - off[c]);
  }
};

// d^2 bits of candidate photon j, or ~0 for an invalid slot (above every
// d^2; d^2 >= 0, so its bits order like the float); the flag and the
// position are loaded together
__device__ __forceinline__ uint32_t d2_bits(const float* __restrict__ ppos,
                                            const uint8_t* __restrict__ pvalid,
                                            int j, float qx, float qy,
                                            float qz) {
  const uint8_t valid = __ldg(pvalid + j);
  const float dx = __ldg(ppos + 3 * j) - qx;
  const float dy = __ldg(ppos + 3 * j + 1) - qy;
  const float dz = __ldg(ppos + 3 * j + 2) - qz;
  return valid ? __float_as_uint(gi_d2(dx, dy, dz)) : ~0u;
}

}  // namespace

__global__ void __launch_bounds__(32 * GI_KNN_WARPS)
gi_knn_kernel(const float* __restrict__ qpos, const float* __restrict__ qdir,
              int n_q, const float* __restrict__ ppos,
              const float* __restrict__ pdir, const float* __restrict__ pcol,
              const uint8_t* __restrict__ pvalid,
              const int32_t* __restrict__ cell_start, int nx, int ny, int nz,
              float gx, float gy, float gz, float ix, float iy, float iz,
              int k, float* __restrict__ out) {
  __shared__ int s_off[GI_KNN_WARPS][28];
  __shared__ int s_beg[GI_KNN_WARPS][27];
  __shared__ uint32_t s_d2[GI_KNN_WARPS][GI_KNN_STAGE];
  __shared__ int s_hist[GI_KNN_WARPS][256];
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
  int incl = cnt;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int n_got = __shfl_sync(kFull, incl, 31);
  if (lane < 27) {
    s_off[w][lane] = incl - cnt;
    s_beg[w][lane] = beg;
  }
  __syncwarp();
  const int* off = s_off[w];
  const int* begs = s_beg[w];

  // ---- 2. d^2 of every candidate ----------------------------------------
  // the first GI_KNN_REG candidates of a lane stay in registers (photon -1
  // and bits ~0 past the window); spill() walks the rest, GI_KNN_UNROLL a
  // lane at a time so that their gathers overlap, in the same number of
  // steps on every lane (past the window: photon -1, bits ~0)
  uint32_t dreg[GI_KNN_REG];
  int jreg[GI_KNN_REG];
#pragma unroll
  for (int t = 0; t < GI_KNN_REG; ++t) {
    const int m = lane + 32 * t;
    jreg[t] = m < n_got ? candidate(off, begs, m) : -1;
  }
#pragma unroll
  for (int t = 0; t < GI_KNN_REG; ++t)
    dreg[t] = jreg[t] >= 0 ? d2_bits(ppos, pvalid, jreg[t], qx, qy, qz) : ~0u;
  auto spill = [&](auto&& visit) {
    Cursor cur;
    for (int m0 = 32 * GI_KNN_REG; m0 < n_got; m0 += 32 * GI_KNN_UNROLL) {
      int j[GI_KNN_UNROLL];
      uint32_t b[GI_KNN_UNROLL];
#pragma unroll
      for (int u = 0; u < GI_KNN_UNROLL; ++u) {
        const int m = m0 + 32 * u + lane;
        j[u] = m < n_got ? cur.photon(off, begs, m) : -1;
      }
#pragma unroll
      for (int u = 0; u < GI_KNN_UNROLL; ++u)
        b[u] = j[u] >= 0 ? d2_bits(ppos, pvalid, j[u], qx, qy, qz) : ~0u;
#pragma unroll
      for (int u = 0; u < GI_KNN_UNROLL; ++u) visit(j[u], b[u]);
    }
  };
  uint32_t lo = ~0u, hi = 0u;
  int found = 0;
  auto tally = [&](int, uint32_t b) {
    if (b != ~0u) {
      ++found;
      lo = min(lo, b);
      hi = max(hi, b);
    }
  };
#pragma unroll
  for (int t = 0; t < GI_KNN_REG; ++t) tally(jreg[t], dreg[t]);
  spill(tally);
  found = __reduce_add_sync(kFull, found);
  if (found == 0) {
    if (lane < 3) o[lane] = 0.0f;
    return;
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);

  // ---- 3. r_k^2: the rank-th smallest d^2 ------------------------------
  uint32_t rk_bits = hi;  // found <= k: the largest d^2
  if (found > k && n_got <= 32 * GI_KNN_REG) {
    // the window is in registers: bisection on the bits (the radix select
    // below serves these windows too, about 1% slower on an H100: PERF.md)
    while (lo < hi) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      int c = 0;
#pragma unroll
      for (int t = 0; t < GI_KNN_REG; ++t) c += dreg[t] <= mid;
      if (__reduce_add_sync(kFull, c) >= k) hi = mid;
      else lo = mid + 1;
    }
    rk_bits = hi;
  } else if (found > k) {
    // a radix select on the bits, 8 at a time from the top: each pass
    // counts the candidates that match the digits found so far into 256
    // bins of the next digit and keeps the bin that holds the rank; once
    // at most GI_KNN_STAGE candidates match, they are copied to shared
    // memory and the remaining digits are counted there
    uint32_t* st = s_d2[w];
    int* hist = s_hist[w];
    uint32_t prefix = 0u, dmask = 0u;
    int rank = k, matching = found, n_st = -1;
    for (int shift = 24; shift >= 0; shift -= 8) {
      auto match = [&](uint32_t b) {
        return b != ~0u && (b & dmask) == prefix;
      };
      if (n_st < 0 && matching <= GI_KNN_STAGE) {
        // appended in warp order, a ballot a step of 32 candidates
        n_st = 0;
        auto stage = [&](int, uint32_t b) {
          const bool keep = match(b);
          const unsigned got = __ballot_sync(kFull, keep);
          const int at = n_st + __popc(got & ((1u << lane) - 1u));
          if (keep && at < GI_KNN_STAGE) st[at] = b;
          n_st += __popc(got);
        };
#pragma unroll
        for (int t = 0; t < GI_KNN_REG; ++t) stage(jreg[t], dreg[t]);
        spill(stage);
        n_st = min(n_st, GI_KNN_STAGE);
      }
      for (int x = lane; x < 256; x += 32) hist[x] = 0;
      __syncwarp();
      auto count = [&](int, uint32_t b) {
        if (match(b)) atomicAdd(hist + ((b >> shift) & 255u), 1);
      };
      if (n_st >= 0) {
        for (int x = lane; x < n_st; x += 32) count(0, st[x]);
      } else {
#pragma unroll
        for (int t = 0; t < GI_KNN_REG; ++t) count(jreg[t], dreg[t]);
        spill(count);
      }
      __syncwarp();
      // the digit: the bin where the running count reaches rank; lane l
      // sums bins 8l..8l+7, a warp scan places the lane that holds it
      int h[8], sum = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        h[e] = hist[8 * lane + e];
        sum += h[e];
      }
      int run = sum;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, run, d);
        if (lane >= d) run += y;
      }
      const bool mine = run - sum < rank && rank <= run;
      int digit = 0, below = run - sum, in_bin = 0;
      if (mine) {
        int acc = run - sum;
        bool seen = false;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (!seen && acc + h[e] >= rank) {
            seen = true;
            digit = 8 * lane + e;
            below = acc;
            in_bin = h[e];
          }
          acc += h[e];
        }
      }
      const int src = __ffs(__ballot_sync(kFull, mine)) - 1;
      digit = __shfl_sync(kFull, digit, src);
      below = __shfl_sync(kFull, below, src);
      in_bin = __shfl_sync(kFull, in_bin, src);
      prefix |= (uint32_t)digit << shift;
      dmask |= 255u << shift;
      rank -= below;
      matching = in_bin;
      __syncwarp();  // every lane has read the bins before they clear
    }
    rk_bits = prefix;
  }

  // ---- 4. weighted sum over every photon within r_k (ties included) -----
  const float qdx = qdir[3 * i], qdy = qdir[3 * i + 1], qdz = qdir[3 * i + 2];
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  auto add = [&](int j, uint32_t b) {
    if (b > rk_bits) return;  // past r_k, or no photon (~0)
    const float wgt = __ldg(pdir + 3 * j) * qdx + __ldg(pdir + 3 * j + 1) * qdy +
                      __ldg(pdir + 3 * j + 2) * qdz;
    sr += __ldg(pcol + 3 * j) * wgt;
    sg += __ldg(pcol + 3 * j + 1) * wgt;
    sb += __ldg(pcol + 3 * j + 2) * wgt;
  };
#pragma unroll
  for (int t = 0; t < GI_KNN_REG; ++t) add(jreg[t], dreg[t]);
  spill(add);
  for (int d = 16; d > 0; d >>= 1) {
    sr += __shfl_xor_sync(kFull, sr, d);
    sg += __shfl_xor_sync(kFull, sg, d);
    sb += __shfl_xor_sync(kFull, sb, d);
  }
  if (lane == 0) {
    const float rk2 = __uint_as_float(rk_bits);
    const float scale = 1.0f / (GI_PI * fmaxf(rk2, 1e-20f));
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
                             float iy, float iz, int k, float* out,
                             cudaStream_t stream) {
  if (k < 1 || k > GI_KNN_KMAX) return (int)cudaErrorInvalidValue;
  const int grid = (n_q + GI_KNN_WARPS - 1) / GI_KNN_WARPS;
  gi_knn_kernel<<<grid, 32 * GI_KNN_WARPS, 0, stream>>>(
      qpos, qdir, n_q, ppos, pdir, pcol, pvalid, cell_start, nx, ny, nz, gx,
      gy, gz, ix, iy, iz, k, out);
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
