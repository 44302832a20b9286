// K4: the superchunk trace, closest hit / any hit for big triangle scenes.
//
// Replaces gi_raytracer_tpu/ops/pallas_intersect.py:388 _stream_kernel
// (launched by _stream_trace for scenes past VMEM_TRI_CAP = 16,384
// triangles).  The TPU kernel keeps the triangles in HBM as 2,048-triangle
// superchunks, culls them per ray outside the kernel, and DMAs them into
// VMEM in ascending entry order behind a collective t cap.  Here the query
// is the walk of walk.cuh with sixteen 128-row chunks per group: a block of
// 256 threads owns a tile of 256 consecutive rays, reduces every ray's slab
// entry into every superchunk box to the tile's least entry per
// superchunk, sorts the entered superchunks, and walks them in that order
// behind the tile's cap.  In a visited superchunk each ray that needs it
// slab-tests the sixteen chunk boxes (built beside the superchunk boxes,
// from the same vertex bounds) and needs only the chunks it enters at or
// before its best t (any hit: while it has no hit).  The (ray, chunk) pairs
// are compacted across the block, the needed chunks are staged two at a
// time in shared memory by cp.async, double-buffered, and every warp tests
// pairs, one row per lane.
//
// What bounds it on the card: FP32 arithmetic, ~41 operations per
// ray-triangle test, in the chunks each ray needs (the per-tile test
// counter reports them), plus the slab tests of the cull (every ray into
// every superchunk box, and each needing ray into the chunk boxes of a
// visited superchunk); the bytes are small beside that (a 1M-triangle table
// is 64 MB, read per visited chunk, mostly from L2).  What is left past the
// arithmetic: the barriers of each visit (three, and two per stage), the
// set-up's pass over every superchunk box, and tiles whose visits outlast
// the others at the end of a launch.
//
// Semantics match the plain version (cuda_stream.prim_query_stream_plain):
// the same cull at both levels, order, caps, per-ray skip, accept test and
// tie rule (smaller t, then smaller prim id); any hit returns the least
// accepted row of the first superchunk in walk order that holds one.
// Inactive lanes return (BIG, -1).

#include "walk.cuh"

#define GI_SC_CHUNKS 16  // 128-row chunks per 2,048-row superchunk

extern "C" int gi_stream_launch(const float* ro, const float* rd,
                                const float* tlim, const uint8_t* active,
                                const int32_t* rid, const float* feat,
                                const float* accept, const float* scbox,
                                const float* cbox, int n_rays, int t_pad,
                                int n_sc, uint32_t salt, float eps,
                                int any_hit, int all_opaque, float* out_t,
                                int32_t* out_prim, int32_t* visits,
                                int32_t* tests, cudaStream_t stream) {
  return gi_walk_launch<GI_SC_CHUNKS>(
      ro, rd, tlim, active, rid, feat, accept, scbox, cbox, n_rays, n_sc,
      t_pad / GI_CHUNK, salt, eps, any_hit, all_opaque, out_t, out_prim,
      visits, tests, stream);
}

extern "C" int gi_stream_info(int n_sc, int* out) {
  return gi_walk_info<GI_SC_CHUNKS>(n_sc, out);
}
