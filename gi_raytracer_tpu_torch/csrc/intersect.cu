// K2: dense closest-hit / any-hit triangle trace, for scenes of at most
// 16,384 triangles (128 chunks of 128 rows; the kernel orders up to 2,048).
//
// Replaces gi_raytracer_tpu/ops/pallas_intersect.py::_kernel (launched by
// _dense_trace).  The TPU kernel tests 256-ray tiles against 128-triangle
// chunks in entry order behind a collective t cap.  Here the same query is
// the walk of walk.cuh with one 128-row chunk per group: a block of 256
// threads owns a tile of 256 rays, reduces every ray's slab entry into
// every chunk box to the tile's least entry per chunk, sorts the entered
// chunks, and walks them in that order behind the tile's cap.  In a visited
// chunk only the rays that need it (entry at or before their best t; any
// hit: no hit yet) enter a compacted list; every warp takes rays from the
// list and tests the chunk's 128 rows, one per lane, from shared memory.
// The next chunk's rows are copied in (cp.async) while this one is tested.
//
// What bounds it on the card: FP32 arithmetic, ~41 operations per
// ray-triangle test, in the chunks each ray needs (the per-tile test
// counter reports them); the bytes are small (a table of <= 16,384 rows is
// 1 MB and stays in L2).  Past the tests, each visit costs three block
// barriers and the per-ray compaction, which dominate where a tile's rays
// need few rows of a chunk.
//
// Semantics match the plain version (cuda_intersect.prim_query_plain): the
// same cull, order, caps, per-ray skip, accept test and tie rule (smaller
// t, then smaller prim id); any hit returns the first accepted row of the
// first chunk in walk order that holds one.  Inactive lanes return
// (BIG, -1).  The brute force (cuda_intersect.prim_query_brute) keeps the
// same winner but for near ties of the approximate t across chunks.

#include "walk.cuh"

extern "C" int gi_trace_launch(const float* ro, const float* rd,
                               const float* tlim, const uint8_t* active,
                               const int32_t* rid, const float* feat,
                               const float* accept, const float* cbox,
                               int n_rays, int t_pad, uint32_t salt,
                               float eps, int any_hit, int all_opaque,
                               float* out_t, int32_t* out_prim,
                               int32_t* visits, int32_t* tests,
                               cudaStream_t stream) {
  const int n_chunks = t_pad / GI_CHUNK;
  return gi_walk_launch<1>(ro, rd, tlim, active, rid, feat, accept, cbox,
                           cbox, n_rays, n_chunks, n_chunks, salt, eps,
                           any_hit, all_opaque, out_t, out_prim, visits,
                           tests, stream);
}

extern "C" int gi_trace_info(int n_chunks, int* out) {
  return gi_walk_info<1>(n_chunks, out);
}
