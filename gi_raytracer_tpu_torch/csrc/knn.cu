// K3: kNN caustic estimate over the photon grid.
//
// Replaces gi_raytracer_tpu/render/photon_knn.py::_tile_kernel_small and
// _tile_kernel_large (launched by _tile_blocks) and _knn_kernel.  The TPU
// kernels serve Morton tiles of 64 (or 16) queries whose window union was
// fetched as 32-photon chunk rows, mask candidates by cell membership, and
// find the exact k-th squared distance by a 32-step bisection on the float
// bits.  That tile machinery exists for the TPU's gather costs and stays
// behind; the exact k-th distance on the float bits stays.  Here two
// launches on one stream answer the queries, with no host sync between:
//
//   1. the warp tier, gi_knn_kernel: one warp a query.  Lanes 0-26 take
//      one window cell each (ox, oy, oz order) and read its photon range
//      from cell_start; a warp scan of the counts turns the window into one
//      flat candidate range (candidate m is photon cell_start[c] + (m -
//      offset[c]) of the cell c whose offsets hold it: a binary search over
//      the 27 offsets, or, along a thread's growing m, a forward walk:
//      Cursor).  A window of more than GI_KNN_FOCAL candidates, what a
//      warp's registers hold, is appended to a device queue (one atomicAdd
//      on its counter) and the warp returns without writing.  Otherwise
//      each lane computes the d^2 (gi_d2, no FMA) of its GI_KNN_REG
//      candidates into registers, r_k^2 comes from a bisection on the
//      float bits, and the weighted sum is a warp reduction.  (A larger
//      threshold, with a warp's radix select past the registers, was
//      slower at 512 and 2048 on an H100: PERF.md.)
//   2. the focal tier, gi_knn_focal_kernel: a persistent grid (the SMs
//      times the blocks resident on each) of GI_KNN_FOCAL_THREADS-thread
//      blocks, each taking queued queries from a second counter until the
//      queue is spent.  A block rebuilds the window's offsets, computes
//      every candidate's d^2 bits once (threads stride over consecutive
//      candidates, so a cell's gathers coalesce) into dynamic shared
//      memory, up to the card's opt-in limit a block (about 57k candidates
//      on an H100), and runs the radix select there: 8 bits a pass from
//      the top, a block-wide 256-bin histogram of the candidates that
//      match the digits found so far, the bin that holds the rank kept.
//      The first pass counts while it stages.  The sum gathers directions
//      and colours of the staged bits within r_k only, then reduces over
//      the block.  A window past the block's capacity takes the same four
//      passes and the sum over d^2 computed again from device memory: a
//      size tier inside the kernel, in the same launch.  The grid's last
//      block to finish zeroes the counters for the next launch, so a call
//      makes no memset.

// Per query (the TPU kernels' estimator, photon_knn.py:71-139,652-760):
//   cell = clamp(trunc((p - grid_min) * inv_cell), 0, dims - 1);
//   27 cells, skipping duplicates at the clamp edge; every valid photon of
//   them is a candidate (no per-cell cap);
//   r_k^2 = the k-th smallest d^2 when more than k photons were found
//   (every d^2 <= r_k^2 counts, ties included), else the largest d^2;
//   est = sum col * (dir . qdir) / (pi * max(r_k^2, 1e-20));
//   0 for an empty window or a far-sentinel query (x >= 1e29).
// Only the order of the sum (a warp's or a block's), and exact ties,
// differ from the plain version.
//
// What bounds it on the card: the gathers of the window's photons
// (positions, then directions and colours of those within r_k) and
// their latency.  A warp a query spreads the short windows, most of a
// wave's queries (tens of candidates), over 32 lanes.  A focal window of
// thousands of candidates (a caustic's focus: 19,704 on the Cornell map's
// wave 0) on one warp paced the whole launch: it read the window up to six
// times while the other queries had finished.  The focal tier reads such
// a window once from device memory with a whole block and selects on
// shared memory, so its time is a few passes over shared memory instead.

#include "common.cuh"

#define GI_KNN_KMAX 64
#define GI_KNN_WARPS 8     // queries per block of 256 threads (warp tier)
#define GI_KNN_REG 4       // candidates a lane keeps in registers
#define GI_KNN_FOCAL (32 * GI_KNN_REG)  // the warp tier's largest window
#define GI_KNN_UNROLL 4    // candidates a focal thread gathers at once
#define GI_KNN_FOCAL_THREADS 1024  // threads of a focal block
#define GI_KNN_COUNTERS 5  // int32 counters a launch takes (gi_knn_launch)

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFocalWarps = GI_KNN_FOCAL_THREADS / 32;

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

// the window cell holding candidate m (offsets: the 27 exclusive prefix
// sums of the cells' counts), by binary search
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

// a thread's walk over its candidates m: within one pass a thread's m only
// grows, so after one search the cell holding it moves forward instead of
// being searched for again
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

// the query's 27 window cells as one candidate range, by one whole warp:
// off[c] the candidates before cell c, beg[c] its first photon (c < 27);
// returns the window's candidates on every lane
__device__ __forceinline__ int gi_window(
    int lane, float qx, float qy, float qz,
    const int32_t* __restrict__ cell_start, int nx, int ny, int nz, float gx,
    float gy, float gz, float ix, float iy, float iz, int* off, int* begs) {
  const int cx = gi_cell(qx, gx, ix, nx);
  const int cy = gi_cell(qy, gy, iy, ny);
  const int cz = gi_cell(qz, gz, iz, nz);
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
  if (lane < 27) {
    off[lane] = incl - cnt;
    begs[lane] = beg;
  }
  return __shfl_sync(kFull, incl, 31);
}

// one radix digit, on one warp: the bin of hist (256) where the running
// count reaches rank, clamped to the count (the largest counted bits when
// fewer were counted).  Lane l sums and clears bins 8l..8l+7, a warp scan
// places the lane that holds the rank.  Returns the digit, and sets below
// (candidates in lower bins) and total (every counted candidate), on every
// lane
__device__ __forceinline__ int radix_digit(int lane, int* hist, int rank,
                                           int& below, int& total) {
  int h[8], sum = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    h[e] = hist[8 * lane + e];
    sum += h[e];
    hist[8 * lane + e] = 0;
  }
  int run = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, run, d);
    if (lane >= d) run += y;
  }
  total = __shfl_sync(kFull, run, 31);
  rank = min(rank, total);
  const bool mine = run - sum < rank && rank <= run;
  int digit = 0;
  below = run - sum;
  if (mine) {
    int acc = run - sum;
    bool seen = false;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (!seen && acc + h[e] >= rank) {
        seen = true;
        digit = 8 * lane + e;
        below = acc;
      }
      acc += h[e];
    }
  }
  const unsigned who = __ballot_sync(kFull, mine);
  const int src = who ? __ffs(who) - 1 : 0;  // none when rank is 0
  below = __shfl_sync(kFull, below, src);
  return __shfl_sync(kFull, digit, src);
}

}  // namespace

// the warp tier: windows of at most GI_KNN_FOCAL candidates, each lane's
// in registers; the rest are queued (queue[counters[0]++]) for
// gi_knn_focal_kernel
__global__ void __launch_bounds__(32 * GI_KNN_WARPS)
gi_knn_kernel(const float* __restrict__ qpos, const float* __restrict__ qdir,
              int n_q, const float* __restrict__ ppos,
              const float* __restrict__ pdir, const float* __restrict__ pcol,
              const uint8_t* __restrict__ pvalid,
              const int32_t* __restrict__ cell_start, int nx, int ny, int nz,
              float gx, float gy, float gz, float ix, float iy, float iz,
              int k, int32_t* __restrict__ queue,
              int32_t* __restrict__ counters, float* __restrict__ out) {
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

  // ---- 1. the window's cells, as one candidate range -------------------
  const int* off = s_off[w];
  const int* begs = s_beg[w];
  const int n_got = gi_window(lane, qx, qy, qz, cell_start, nx, ny, nz, gx,
                              gy, gz, ix, iy, iz, s_off[w], s_beg[w]);
  if (n_got > GI_KNN_FOCAL) {  // the focal tier answers it
    if (lane == 0) queue[atomicAdd(counters, 1)] = i;
    return;
  }
  __syncwarp();

  // ---- 2. d^2 of every candidate, GI_KNN_REG a lane (photon -1 and bits
  // ~0 past the window) ----------------------------------------------------
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
  uint32_t lo = ~0u, hi = 0u;
  int found = 0;
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

  // ---- 3. r_k^2: the k-th smallest d^2, by bisection on the bits (found
  // <= k: the largest d^2) --------------------------------------------------
  if (found > k) {
    while (lo < hi) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      int c = 0;
#pragma unroll
      for (int t = 0; t < GI_KNN_REG; ++t) c += dreg[t] <= mid;
      if (__reduce_add_sync(kFull, c) >= k) hi = mid;
      else lo = mid + 1;
    }
  }
  const uint32_t rk_bits = hi;

  // ---- 4. weighted sum over every photon within r_k (ties included) -----
  const float qdx = qdir[3 * i], qdy = qdir[3 * i + 1], qdz = qdir[3 * i + 2];
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
#pragma unroll
  for (int t = 0; t < GI_KNN_REG; ++t) {
    if (dreg[t] > rk_bits) continue;  // past r_k, or no photon (~0)
    const int j = jreg[t];
    const float wgt = __ldg(pdir + 3 * j) * qdx + __ldg(pdir + 3 * j + 1) * qdy +
                      __ldg(pdir + 3 * j + 2) * qdz;
    sr += __ldg(pcol + 3 * j) * wgt;
    sg += __ldg(pcol + 3 * j + 1) * wgt;
    sb += __ldg(pcol + 3 * j + 2) * wgt;
  }
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

// the focal tier: a block a queued query, taken in turn (counters[1]) until
// the queue (counters[0] entries, final when the warp tier ended) is spent;
// a window of at most `capacity` candidates is staged in the dynamic
// shared memory s_bits, a larger one is read from device memory each pass.
// The last block to finish (counters[2] counts them) keeps the launch's
// two counts in counters[3..4], adds them to totals[0..1] where totals is
// not null, and zeroes counters[0..2] for the next one
__global__ void __launch_bounds__(GI_KNN_FOCAL_THREADS, 1)
gi_knn_focal_kernel(const float* __restrict__ qpos,
                    const float* __restrict__ qdir,
                    const float* __restrict__ ppos,
                    const float* __restrict__ pdir,
                    const float* __restrict__ pcol,
                    const uint8_t* __restrict__ pvalid,
                    const int32_t* __restrict__ cell_start, int nx, int ny,
                    int nz, float gx, float gy, float gz, float ix, float iy,
                    float iz, int k, const int32_t* __restrict__ queue,
                    int32_t* __restrict__ counters, int capacity,
                    long long* __restrict__ totals,
                    float* __restrict__ out) {
  extern __shared__ uint32_t s_bits[];
  __shared__ int s_off[28];  // [27]: the window's candidates
  __shared__ int s_beg[27];
  __shared__ int s_hist[256];
  __shared__ float s_sum[kFocalWarps][3];
  __shared__ int s_item, s_digit, s_below, s_found;
  constexpr int T = GI_KNN_FOCAL_THREADS;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int n_focal = *(volatile const int32_t*)counters;
  if (tid < 256) s_hist[tid] = 0;  // kept clear: the digit pass clears it
  for (;;) {
    if (tid == 0) s_item = atomicAdd(counters + 1, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= n_focal) {  // the whole block
      if (tid == 0) {
        __threadfence();
        if (atomicAdd(counters + 2, 1) == (int)gridDim.x - 1) {
          const int queued = atomicExch(counters, 0);
          const int taken = atomicExch(counters + 1, 0);
          counters[3] = queued;
          counters[4] = taken;
          counters[2] = 0;
          if (totals) {  // one launch at a time on one stream adds here
            totals[0] += queued;
            totals[1] += taken;
          }
        }
      }
      return;
    }
    const int i = queue[item];
    const float qx = qpos[3 * i], qy = qpos[3 * i + 1], qz = qpos[3 * i + 2];
    if (w == 0) {
      const int n = gi_window(lane, qx, qy, qz, cell_start, nx, ny, nz, gx,
                              gy, gz, ix, iy, iz, s_off, s_beg);
      if (lane == 0) s_off[27] = n;
    }
    __syncthreads();
    const int n_got = s_off[27];
    const bool staged = n_got <= capacity;

    // the candidates from device memory, GI_KNN_UNROLL a thread at a time
    // so that their gathers overlap: visit(m, photon, bits), with photon -1
    // and bits ~0 past the window
    auto walk = [&](auto&& visit) {
      Cursor cur;
      for (int m0 = 0; m0 < n_got; m0 += T * GI_KNN_UNROLL) {
        int j[GI_KNN_UNROLL];
        uint32_t b[GI_KNN_UNROLL];
#pragma unroll
        for (int u = 0; u < GI_KNN_UNROLL; ++u) {
          const int m = m0 + T * u + tid;
          j[u] = m < n_got ? cur.photon(s_off, s_beg, m) : -1;
        }
#pragma unroll
        for (int u = 0; u < GI_KNN_UNROLL; ++u)
          b[u] = j[u] >= 0 ? d2_bits(ppos, pvalid, j[u], qx, qy, qz) : ~0u;
#pragma unroll
        for (int u = 0; u < GI_KNN_UNROLL; ++u)
          visit(m0 + T * u + tid, j[u], b[u]);
      }
    };
    // every candidate's bits, staged or read again (photon -1 when staged:
    // the visitor finds it from m)
    auto each = [&](auto&& visit) {
      if (staged) {
        for (int m = tid; m < n_got; m += T) visit(m, -1, s_bits[m]);
      } else {
        walk(visit);
      }
    };

    // ---- radix select of the rank-th smallest d^2, rank = min(k, found):
    // the first pass stages the bits while it counts their top digit
    uint32_t prefix = 0u, dmask = 0u;
    int rank = 0, found = 0;
    for (int shift = 24; shift >= 0; shift -= 8) {
      if (shift == 24) {
        walk([&](int m, int, uint32_t b) {
          if (staged && m < n_got) s_bits[m] = b;
          if (b != ~0u) atomicAdd(s_hist + (b >> 24), 1);
        });
      } else {
        each([&](int, int, uint32_t b) {
          if (b != ~0u && (b & dmask) == prefix)
            atomicAdd(s_hist + ((b >> shift) & 255u), 1);
        });
      }
      __syncthreads();
      if (w == 0) {
        // the first pass counts every valid candidate (found) and looks
        // for rank min(k, found)
        int below, total;
        const int digit = radix_digit(lane, s_hist, shift == 24 ? k : rank,
                                      below, total);
        if (lane == 0) {
          s_digit = digit;
          s_below = below;
          if (shift == 24) s_found = total;
        }
      }
      __syncthreads();
      if (shift == 24) {
        found = s_found;
        if (found == 0) break;
        rank = min(k, found);
      }
      prefix |= (uint32_t)s_digit << shift;
      dmask |= 255u << shift;
      rank -= s_below;
    }
    float* o = out + 3 * i;
    if (found == 0) {  // no valid photon in the window
      if (tid < 3) o[tid] = 0.0f;
      continue;
    }

    // ---- weighted sum over every photon within r_k (ties included) ------
    const uint32_t rk_bits = prefix;
    const float qdx = qdir[3 * i], qdy = qdir[3 * i + 1],
                qdz = qdir[3 * i + 2];
    float sr = 0.0f, sg = 0.0f, sb = 0.0f;
    each([&](int m, int j, uint32_t b) {
      if (b > rk_bits) return;  // past r_k, or no photon (~0)
      if (j < 0) j = candidate(s_off, s_beg, m);
      const float wgt = __ldg(pdir + 3 * j) * qdx +
                        __ldg(pdir + 3 * j + 1) * qdy +
                        __ldg(pdir + 3 * j + 2) * qdz;
      sr += __ldg(pcol + 3 * j) * wgt;
      sg += __ldg(pcol + 3 * j + 1) * wgt;
      sb += __ldg(pcol + 3 * j + 2) * wgt;
    });
    for (int d = 16; d > 0; d >>= 1) {
      sr += __shfl_xor_sync(kFull, sr, d);
      sg += __shfl_xor_sync(kFull, sg, d);
      sb += __shfl_xor_sync(kFull, sb, d);
    }
    if (lane == 0) {
      s_sum[w][0] = sr;
      s_sum[w][1] = sg;
      s_sum[w][2] = sb;
    }
    __syncthreads();
    if (w == 0) {
      sr = lane < kFocalWarps ? s_sum[lane][0] : 0.0f;
      sg = lane < kFocalWarps ? s_sum[lane][1] : 0.0f;
      sb = lane < kFocalWarps ? s_sum[lane][2] : 0.0f;
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
  }
}

namespace {

// the focal tier's launch shape on the current device, found once: its
// dynamic shared bytes (the opt-in limit less its static shared memory,
// after raising the kernel's limit to it), resident blocks per SM, grid
struct FocalShape {
  int dyn = -1, blocks = 0, grid = 0;
};

cudaError_t focal_shape(FocalShape* out) {
  static FocalShape cache[16];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && cache[dev].dyn >= 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gi_knn_focal_kernel);
  if (err != cudaSuccess) return err;
  FocalShape s;
  s.dyn = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(gi_knn_focal_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             s.dyn);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &s.blocks, gi_knn_focal_kernel, GI_KNN_FOCAL_THREADS, s.dyn);
  if (err != cudaSuccess) return err;
  if (s.blocks < 1) return cudaErrorInvalidConfiguration;
  s.grid = s.blocks * sms;
  if (dev < 16) cache[dev] = s;
  *out = s;
  return cudaSuccess;
}

}  // namespace

// both tiers on `stream`: queue (n_q int32) and counters (GI_KNN_COUNTERS
// int32, zero before the first launch; each launch leaves counters[0..2]
// zero and its queued and taken counts in counters[3..4]) are the caller's
// scratch, used by one launch at a time.  A refused launch leaves the
// counters zeroed too.  totals: null, or two int64 (memory the card can
// write, such as pinned host memory) the launch adds its two counts to
extern "C" int gi_knn_launch(const float* qpos, const float* qdir, int n_q,
                             const float* ppos, const float* pdir,
                             const float* pcol, const uint8_t* pvalid,
                             const int32_t* cell_start, int nx, int ny,
                             int nz, float gx, float gy, float gz, float ix,
                             float iy, float iz, int k, int32_t* queue,
                             int32_t* counters, long long* totals,
                             float* out, cudaStream_t stream) {
  if (k < 1 || k > GI_KNN_KMAX) return (int)cudaErrorInvalidValue;
  FocalShape shape;
  cudaError_t err = focal_shape(&shape);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_q + GI_KNN_WARPS - 1) / GI_KNN_WARPS;
  gi_knn_kernel<<<grid, 32 * GI_KNN_WARPS, 0, stream>>>(
      qpos, qdir, n_q, ppos, pdir, pcol, pvalid, cell_start, nx, ny, nz, gx,
      gy, gz, ix, iy, iz, k, queue, counters, out);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    gi_knn_focal_kernel<<<shape.grid, GI_KNN_FOCAL_THREADS, shape.dyn,
                          stream>>>(qpos, qdir, ppos, pdir, pcol, pvalid,
                                    cell_start, nx, ny, nz, gx, gy, gz, ix,
                                    iy, iz, k, queue, counters,
                                    shape.dyn / 4, totals, out);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess)  // the queue was filled but not spent
    cudaMemsetAsync(counters, 0, 3 * sizeof(int32_t), stream);
  return (int)err;
}

// resources of both tiers: out[0] the warp tier's resident blocks per SM,
// out[1] registers per thread, out[2] local (spill) bytes per thread,
// out[3] dynamic and out[4] static shared bytes per block, out[5] threads
// per block, out[6] candidates a warp keeps in registers (its threshold,
// GI_KNN_FOCAL); out[7..12] the same five resources and threads of the
// focal tier, out[13] its grid, out[14] the candidates it stages in shared
// memory, out[15] the counters a launch takes
extern "C" int gi_knn_info(int* out) {
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gi_knn_kernel, 32 * GI_KNN_WARPS, 0);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gi_knn_kernel);
  if (err != cudaSuccess) return (int)err;
  FocalShape shape;
  err = focal_shape(&shape);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fattr;
  err = cudaFuncGetAttributes(&fattr, gi_knn_focal_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = 0;
  out[4] = (int)attr.sharedSizeBytes;
  out[5] = 32 * GI_KNN_WARPS;
  out[6] = GI_KNN_FOCAL;
  out[7] = shape.blocks;
  out[8] = fattr.numRegs;
  out[9] = (int)fattr.localSizeBytes;
  out[10] = shape.dyn;
  out[11] = (int)fattr.sharedSizeBytes;
  out[12] = GI_KNN_FOCAL_THREADS;
  out[13] = shape.grid;
  out[14] = shape.dyn / 4;
  out[15] = GI_KNN_COUNTERS;
  return 0;
}
