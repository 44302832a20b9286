"""The superchunk trace (K4): CUDA kernel wrapper + plain version.

Counterpart of ``gi_raytracer_tpu.ops.pallas_intersect._stream_kernel``
(launched where ``routes.trace`` names K4).  It
answers the query of the dense trace (``cuda_intersect``): per ray, the
accepted triangle with the smallest approximate t below the ray's t limit,
ties to the smallest prim id, or with ``any_hit`` whether one lies in
(0, t_lim); the same feature rows, accept test, bfloat16-rounded
reciprocal and stochastic-alpha stream (keyed on the caller's ray ids and
the global prim id).

It is the walk of ``cuda_intersect.walk_plain`` (``csrc/walk.cuh``) with
two levels: the groups are **superchunks**, 2,048 consecutive rows of the
BVH-leaf-ordered feature table (``build_superchunk_boxes``), which a tile
of 256 rays orders by entry and walks behind its cap; inside a visited
superchunk each ray tests only the 128-row chunks whose boxes
(``cuda_intersect.build_boxes(scene, t_pad, CHUNK_ROWS)``) it enters at or
before its best t (any hit: while it has no hit).

``prim_query_stream`` is the wrapper: on CPU tensors it runs
:func:`prim_query_stream_plain`; on CUDA tensors it launches
``csrc/stream.cu`` or raises.
"""

from __future__ import annotations

from . import _cuda
from . import cuda_intersect as ci

SC_TRIS = 2048            # triangles (feature rows) per superchunk; the
                          # kernel orders up to ci.MAX_GROUPS of them
RAY_TILE = ci.RAY_TILE    # rays per tile (one CUDA block)


def n_superchunks(t_pad: int) -> int:
    return -(-t_pad // SC_TRIS)


def build_superchunk_boxes(scene, t_pad: int):
    """(8, n_sc) f32 superchunk bounds (``cuda_intersect.build_boxes`` of
    2,048-row groups)."""
    return ci.build_boxes(scene, t_pad, SC_TRIS)


def prim_query_stream_plain(feat, accept, scbox, cbox, ro, rd, t_lim, active,
                            ray_id, salt, eps=1e-5, any_hit=False,
                            all_opaque=False, return_counts=False):
    """K4's plain version: the two-level walk (superchunks, then their
    128-row chunks).  Returns (t_approx (R,) f32, prim (R,) int32), and
    with ``return_counts`` the (n_tiles,) int32 superchunks each tile
    visited and ray-triangle tests it needed."""
    _cuda.plain_calls["stream"] += 1
    return ci.walk_plain(feat, accept, scbox, cbox, ro, rd, t_lim, active,
                         ray_id, salt, eps, any_hit, all_opaque,
                         return_counts, SC_TRIS)


def prim_query_stream(feat, accept, scbox, cbox, ro, rd, t_lim, active,
                      ray_id, salt, eps=1e-5, any_hit=False, all_opaque=False,
                      return_counts=False):
    """(t_approx (R,), prim (R,)) for the winning triangle per ray (-1 =
    miss), and with ``return_counts`` the per-tile visit and test counts.
    ``scbox`` is ``build_superchunk_boxes`` and ``cbox`` the chunk boxes of
    the table ``feat``."""
    if ro.device.type == "cpu":
        return prim_query_stream_plain(feat, accept, scbox, cbox, ro, rd,
                                       t_lim, active, ray_id, salt, eps,
                                       any_hit, all_opaque, return_counts)
    return _stream_cuda(feat, accept, scbox, cbox, ro, rd, t_lim, active,
                        ray_id, salt, eps, any_hit, all_opaque, return_counts)


def _stream_cuda(feat, accept, scbox, cbox, ro, rd, t_lim, active, ray_id,
                 salt, eps, any_hit, all_opaque, return_counts):
    return ci.walk_cuda("prim_query_stream", "stream", feat, accept,
                        (scbox, cbox), n_superchunks(feat.shape[0]), ro, rd,
                        t_lim, active, ray_id, salt, eps, any_hit,
                        all_opaque, return_counts)
