// The fog march in one launch: each lane's first scattering step along its
// segment of the fog box (render/atmosphere.py, _march).
//
// Replaces no TPU kernel: the JAX package marches one step at a time in
// XLA (gi_raytracer_tpu/render/atmosphere.py).  The port's plain version is
// _march, the march as torch operations on (lanes, 32) tensors: some 200
// operations and five host waits a block of 32 steps, which left the card
// idle most of a fog frame.  Here one thread owns one lane and walks its
// steps i = 0, 1, ... up to max_steps - 1:
//
//   * t = t0 + (float)((double)i * step), _step_offsets' rounding; the
//     lane stops at the first step with !(t < tmax), and since t never
//     decreases with i no later step could scatter;
//   * the scatter draw hash_u01(lane id, i, salt) (common.cuh) against
//     fog_density(ro + t rd), computed as torch computes it on the card,
//     operation for operation: every product, sum and quotient rounded on
//     its own (torch_f32.cuh), the clamps' bounds rounded to float32 as
//     torch rounds a Python number, ** 7 torch's pow kernel (powf with the
//     exponent 7.0f, not a constant the compiler could fold) and ** 2 a
//     product;
//   * the lane stops at its first scattering step and writes found and
//     that step's index; the caller rebuilds t from it in torch, so the
//     march's t_hit and its gradient are _march's.
//
// The noise grid (33x17x17 floats, 38 KB, in the fog cell) is staged in
// shared memory by each block that holds a marching lane; a block whose
// lanes all skip the march loads nothing.  What bounds it: the lane-steps,
// some 70 float operations and eight shared reads each (301.7 M a frame of
// the fog cell: 0.3 ms at 67 TFLOP/s).  It runs at a few percent of that:
// a step is a chain of dependent operations (the hash, the point, the
// density), the lanes of a warp march different lengths, the longest
// setting the warp's pace, and on primary rays three lanes in four march
// nothing.  Skipping the density of draws that no point could reach (a
// tenth of the steps computed at the cell's density) changed nothing on
// the card, and 128, 256 and 512 threads a block are within 8% of each
// other, the grid read through L1 within 7% of shared memory.
//
// Counts (while the program records, as K3 adds its totals): the lanes
// entering the march, the lane-steps and blocks of 32 steps the blocked
// march would run (a lane enters block b if it has not scattered before it
// and t0 + off(32 b) < tmax; each block it enters counts that block's
// steps; the march runs as many blocks as its longest lane enters), summed
// in a device scratch and written by the last block to finish to three
// int64 in pinned host memory, with no launch of their own.

#include <stdint.h>

#include "common.cuh"
#include "torch_f32.cuh"

#define GI_FOG_THREADS 256
#define GI_FOG_MAX_GRID_BYTES (227 * 1024)  // sm_90's shared memory a block

namespace {

struct GiFogArgs {
  const float* __restrict__ ro;  // (R, 3), rows ro_stride floats apart
  const float* __restrict__ rd;  // (R, 3), rows rd_stride floats apart
  const float* __restrict__ t0;  // (R,) tmin + shadow_bias
  const float* __restrict__ tmax;
  const uint8_t* __restrict__ has;   // (R,) bool
  const int64_t* __restrict__ rid;   // the lanes' ids, or null: the index
  const float* __restrict__ bmin;    // (3,)
  const float* __restrict__ bmax;    // (3,)
  const float* __restrict__ density; // ()
  const float* __restrict__ grid;    // (nx, ny, nz)
  uint8_t* __restrict__ found;       // (R,) bool
  int32_t* __restrict__ step;        // (R,) the scattering step, else 0
  // lanes, lane-steps, blocks (a maximum), blocks done: zero between
  // launches
  unsigned long long* __restrict__ scratch;
  long long* __restrict__ totals;    // lanes, lane-steps, blocks; or null
  long long ro_stride, rd_stride;
  int n_lanes, max_steps, block_steps, nx, ny, nz, n_grid;
  float top_x, top_y, top_z;  // float32(n - 1.001): the clamps' bounds
  float noise_pow;            // 7
  double step_size;
  uint32_t salt;
};

// atmosphere.fog_density at p, the grid g (shared memory)
__device__ __forceinline__ float fog_density(const GiFogArgs& a, F3 lo, F3 hi,
                                             float size_y, float dens,
                                             const float* g, F3 p) {
  if (!(p.x >= lo.x && p.y >= lo.y && p.z >= lo.z && p.x <= hi.x &&
        p.y <= hi.y && p.z <= hi.z))
    return 0.0f;
  const float gx = clamp(sub(p.x, lo.x), 0.0f, a.top_x);
  const float gy = clamp(sub(p.y, lo.y), 0.0f, a.top_y);
  const float gz = clamp(sub(p.z, lo.z), 0.0f, a.top_z);
  const int ix = (int)gx, iy = (int)gy, iz = (int)gz;
  const float dx = sub(gx, (float)ix), dy = sub(gy, (float)iy),
              dz = sub(gz, (float)iz);
  const int x1 = min(ix + 1, a.nx - 1), y1 = min(iy + 1, a.ny - 1),
            z1 = min(iz + 1, a.nz - 1);
  // at(ox, oy, oz): g[x][y][z], rows (x, y) of nz floats
  const int r00 = (ix * a.ny + iy) * a.nz, r10 = (x1 * a.ny + iy) * a.nz,
            r01 = (ix * a.ny + y1) * a.nz, r11 = (x1 * a.ny + y1) * a.nz;
  const float ex = sub(1.0f, dx), ey = sub(1.0f, dy), ez = sub(1.0f, dz);
  const float c00 = add(mul(g[r00 + iz], ex), mul(g[r10 + iz], dx));
  const float c01 = add(mul(g[r00 + z1], ex), mul(g[r10 + z1], dx));
  const float c10 = add(mul(g[r01 + iz], ex), mul(g[r11 + iz], dx));
  const float c11 = add(mul(g[r01 + z1], ex), mul(g[r11 + z1], dx));
  const float c0 = add(mul(c00, ey), mul(c10, dy));
  const float c1 = add(mul(c01, ey), mul(c11, dy));
  const float noise = powf(add(mul(c0, ez), mul(c1, dz)), a.noise_pow);
  const float f = quo(sub(hi.y, p.y), size_y);
  return mul(mul(dens, noise), mul(f, f));
}

// lane i's march over the grid g: its scattering step, or -1 - the steps
// it reached (t < tmax) without scattering
__device__ __forceinline__ int march_lane(const GiFogArgs& a, const float* g,
                                          int i, float t0, float tmax) {
  const F3 lo = f3(__ldg(a.bmin), __ldg(a.bmin + 1), __ldg(a.bmin + 2));
  const F3 hi = f3(__ldg(a.bmax), __ldg(a.bmax + 1), __ldg(a.bmax + 2));
  const float size_y = sub(hi.y, lo.y), dens = __ldg(a.density);
  const float* o = a.ro + i * a.ro_stride;
  const float* d = a.rd + i * a.rd_stride;
  const F3 ro = f3(o[0], o[1], o[2]), rd = f3(d[0], d[1], d[2]);
  const uint32_t id = a.rid != nullptr ? (uint32_t)a.rid[i] : (uint32_t)i;
  int k = 0;
  for (; k < a.max_steps; ++k) {
    const float t = add(t0, __double2float_rn((double)k * a.step_size));
    if (!(t < tmax)) break;
    const F3 p = f3(add(ro.x, mul(t, rd.x)), add(ro.y, mul(t, rd.y)),
                    add(ro.z, mul(t, rd.z)));
    if (gi_hash_u01(id, (uint32_t)k, a.salt) <
        fog_density(a, lo, hi, size_y, dens, g, p))
      return k;
  }
  return -1 - k;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(~0u, v, o);
  return v;
}

__global__ void __launch_bounds__(GI_FOG_THREADS)
    gi_fog_march_kernel(const GiFogArgs a) {
  extern __shared__ float4 s_grid4[];
  const int i = blockIdx.x * GI_FOG_THREADS + threadIdx.x;
  float t0 = 0.0f, tmax = 0.0f;
  bool live = false;
  if (i < a.n_lanes) {
    t0 = a.t0[i];
    tmax = a.tmax[i];
    live = a.has[i] && t0 < tmax;
  }
  int got = -1;  // as march_lane; a lane that skips reached no step
  if (__syncthreads_or(live)) {
    float* s = reinterpret_cast<float*>(s_grid4);
    int j0 = 0;
    if ((reinterpret_cast<uintptr_t>(a.grid) & 15) == 0) {
      const float4* g4 = reinterpret_cast<const float4*>(a.grid);
      j0 = a.n_grid & ~3;
      for (int j = threadIdx.x; j < (j0 >> 2); j += GI_FOG_THREADS)
        s_grid4[j] = __ldg(g4 + j);
    }
    for (int j = j0 + threadIdx.x; j < a.n_grid; j += GI_FOG_THREADS)
      s[j] = __ldg(a.grid + j);
    __syncthreads();
    if (live) got = march_lane(a, s, i, t0, tmax);
  }
  if (i < a.n_lanes) {
    a.found[i] = got >= 0;
    a.step[i] = got >= 0 ? got : 0;
  }
  if (a.totals == nullptr) return;
  // the blocked march's counts of this lane
  const int B = a.block_steps;
  const long long blocks =
      !live ? 0 : got >= 0 ? got / B + 1 : ((-1 - got) + B - 1) / B;
  const long long steps = min(blocks * B, (long long)a.max_steps);
  const unsigned long long n_live = warp_sum(live);
  const unsigned long long n_steps = warp_sum(steps);
  unsigned long long most = blocks;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    most = max(most, __shfl_down_sync(~0u, most, o));
  if ((threadIdx.x & 31) == 0 && n_live) {
    atomicAdd(a.scratch, n_live);
    atomicAdd(a.scratch + 1, n_steps);
    atomicMax(a.scratch + 2, most);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(a.scratch + 3, 1ull) == gridDim.x - 1) {
      // one launch at a time on one stream writes here
      a.totals[0] += (long long)atomicExch(a.scratch, 0ull);
      a.totals[1] += (long long)atomicExch(a.scratch + 1, 0ull);
      a.totals[2] =
          max(a.totals[2], (long long)atomicExch(a.scratch + 2, 0ull));
      a.scratch[3] = 0ull;
    }
  }
}

// the dynamic shared memory a grid of n floats takes
int grid_bytes(int n_grid) { return ((n_grid + 3) & ~3) * 4; }

}  // namespace

// one march on `stream`: found and step for every lane; scratch is the
// caller's four uint64 zeros, left zero; totals null or three int64 the
// card can write (such as pinned host memory)
extern "C" int gi_fog_march_launch(
    const float* ro, long long ro_stride, const float* rd,
    long long rd_stride, const float* t0, const float* tmax,
    const uint8_t* has, const int64_t* rid, int n_lanes, uint32_t salt,
    const float* bmin, const float* bmax, const float* density,
    const float* grid, int nx, int ny, int nz, float top_x, float top_y,
    float top_z, float noise_pow, double step_size, int max_steps,
    int block_steps, uint8_t* found, int32_t* step,
    unsigned long long* scratch, long long* totals, cudaStream_t stream) {
  const long long n_grid = (long long)nx * ny * nz;
  if (n_lanes < 1 || nx < 1 || ny < 1 || nz < 1 || block_steps < 1 ||
      n_grid * 4 > GI_FOG_MAX_GRID_BYTES)
    return (int)cudaErrorInvalidValue;
  const int smem = grid_bytes((int)n_grid);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gi_fog_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  GiFogArgs a = {};
  a.ro = ro;
  a.rd = rd;
  a.t0 = t0;
  a.tmax = tmax;
  a.has = has;
  a.rid = rid;
  a.bmin = bmin;
  a.bmax = bmax;
  a.density = density;
  a.grid = grid;
  a.found = found;
  a.step = step;
  a.scratch = scratch;
  a.totals = totals;
  a.ro_stride = ro_stride;
  a.rd_stride = rd_stride;
  a.n_lanes = n_lanes;
  a.max_steps = max_steps;
  a.block_steps = block_steps;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.n_grid = (int)n_grid;
  a.top_x = top_x;
  a.top_y = top_y;
  a.top_z = top_z;
  a.noise_pow = noise_pow;
  a.step_size = step_size;
  a.salt = salt;
  const int blocks = (n_lanes + GI_FOG_THREADS - 1) / GI_FOG_THREADS;
  gi_fog_march_kernel<<<blocks, GI_FOG_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// resources for a grid of n_grid floats: out[0] resident blocks per SM,
// out[1] registers per thread, out[2] local (spill) bytes per thread,
// out[3] dynamic shared bytes per block, out[4] threads per block
extern "C" int gi_fog_march_info(int n_grid, int* out) {
  const int smem = grid_bytes(n_grid);
  cudaError_t err = cudaFuncSetAttribute(
      gi_fog_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gi_fog_march_kernel, GI_FOG_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gi_fog_march_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = smem;
  out[4] = GI_FOG_THREADS;
  return 0;
}
