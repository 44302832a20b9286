"""Ray-scene intersection for triangle scenes.

Counterpart of ``gi_raytracer_tpu.ops.intersect`` on its Pallas route:
scenes of at most ``VMEM_TRI_CAP`` triangles go through the dense trace
(``cuda_intersect.prim_query``, K2), bigger ones through the superchunk
trace (``cuda_stream.prim_query_stream``, K4); each is the CUDA kernel on
the card and its plain version on the CPU.  The exact Moller-Trumbore
(t, u, v) of the winner is recomputed here.  The BVH walk, analytic
spheres and cones are not ported yet.

``plain=True`` runs the trace's plain version on any device (the card's
comparison runs use it); nothing on the render path passes it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_intersect as ci
from . import cuda_stream as cs

# The JAX package's name for the scene size up to which the dense trace
# runs: there its VMEM-resident table; here the size past which a scene's
# queries go to the superchunk trace (K4) instead of K2's walk over single
# 128-triangle chunks.
VMEM_TRI_CAP = 16_384


class Hit(NamedTuple):
    t: torch.Tensor        # (R,) hit distance (inf = miss)
    prim: torch.Tensor     # (R,) int32 triangle id, -1 miss
    u: torch.Tensor        # (R,) barycentric u
    v: torch.Tensor        # (R,) barycentric v


def ray_triangle(ro, rd, v0, e1, e2, eps):
    """Branchless Moller-Trumbore.  Returns (t, u, v, ok)."""
    p = torch.linalg.cross(rd, e2, dim=-1)
    det = torch.sum(e1 * p, -1)
    ok = torch.abs(det) >= eps
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = ro - v0
    u = torch.sum(tvec * p, -1) * inv_det
    q = torch.linalg.cross(tvec, e1, dim=-1)
    v = torch.sum(rd * q, -1) * inv_det
    t = torch.sum(e2 * q, -1) * inv_det
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    return t, u, v, ok


def _check_scene(scene):
    if scene.n_spheres or scene.n_cones:
        raise NotImplementedError("analytic spheres/cones are not ported yet")


def trace_tables(scene):
    """The scene's trace tables (``build_tri_features``), built once per
    Scene object and kept on it."""
    tab = scene.__dict__.get("_trace_tables")
    if tab is None:
        tab = ci.build_tri_features(scene)
        scene.__dict__["_trace_tables"] = tab
    return tab


def chunk_boxes(scene):
    """The scene's 128-row chunk boxes (``cuda_intersect.build_boxes`` of
    its trace table), which K2 and K4 walk; built once per Scene object and
    kept on it."""
    box = scene.__dict__.get("_chunk_boxes")
    if box is None:
        box = ci.build_boxes(scene, trace_tables(scene)[0].shape[0],
                             ci.CHUNK_ROWS)
        scene.__dict__["_chunk_boxes"] = box
    return box


def stream_boxes(scene):
    """The scene's superchunk boxes (``cuda_stream.build_superchunk_boxes``
    of its trace table), built once per Scene object and kept on it."""
    box = scene.__dict__.get("_stream_boxes")
    if box is None:
        box = cs.build_superchunk_boxes(scene, trace_tables(scene)[0].shape[0])
        scene.__dict__["_stream_boxes"] = box
    return box


def uses_stream(scene) -> bool:
    """Whether the scene's queries go to the superchunk trace (K4)."""
    return scene.n_tris > VMEM_TRI_CAP


def _query(scene, ro, rd, t_max, salt, eps, active, ray_id, any_hit, plain):
    _check_scene(scene)
    R = ro.shape[0]
    dev = ro.device
    feat, accept = trace_tables(scene)
    tl = (torch.full((R,), ci.BIG, dtype=torch.float32, device=dev)
          if t_max is None
          else torch.broadcast_to(torch.as_tensor(t_max, device=dev),
                                  (R,)).float())
    act = (torch.ones(R, dtype=torch.bool, device=dev) if active is None
           else active)
    rid = (torch.arange(R, dtype=torch.int64, device=dev) if ray_id is None
           else ray_id)
    args = (ro.detach(), rd.detach(), tl.detach(), act, rid, salt, eps,
            any_hit, scene.all_opaque)
    if uses_stream(scene):
        fn = cs.prim_query_stream_plain if plain else cs.prim_query_stream
        return fn(feat, accept, stream_boxes(scene), chunk_boxes(scene),
                  *args)
    fn = ci.prim_query_plain if plain else ci.prim_query
    return fn(feat, accept, chunk_boxes(scene), *args)


def trace_closest_rows(scene, rows, ro, rd, t_max=None, salt=0, eps=1e-5,
                       active=None, ray_id=None, plain=False):
    """Closest hit plus the winner's packed shade row (rows = the scene's
    ``build_prim_rows`` table).  The exact (t, u, v) is recomputed from the
    row.  Returns (Hit, row (R, PR_W))."""
    _, prim = _query(scene, ro, rd, t_max, salt, eps, active, ray_id,
                     False, plain)
    row = rows[torch.clamp(prim, 0, rows.shape[0] - 1).long()]
    t, u, v, ok = ray_triangle(ro, rd, row[:, 0:3], row[:, 3:6], row[:, 6:9],
                               eps)
    m = (prim >= 0) & ok
    hit = Hit(torch.where(m, t, torch.inf), torch.where(m, prim, -1),
              torch.where(m, u, 0.0), torch.where(m, v, 0.0))
    return hit, row


def exact_hit(scene, ro, rd, prim, eps):
    """Exact (t, u, v, prim) of the kernel-selected triangle; lanes where
    the exact test disagrees with the kernel's accept become misses."""
    tr = scene.tris
    p = torch.clamp(prim, 0, max(tr.v0.shape[0] - 1, 0)).long()
    t, u, v, valid = ray_triangle(ro, rd, tr.v0[p], tr.e1[p], tr.e2[p], eps)
    m = (prim >= 0) & valid
    return (torch.where(m, t, torch.inf), torch.where(m, u, 0.0),
            torch.where(m, v, 0.0), torch.where(m, prim, -1))


def trace_closest(scene, ro, rd, t_max=None, salt=0, eps=1e-5, active=None,
                  ray_id=None, plain=False) -> Hit:
    """Closest accepted hit per ray (triangles), exact (t, u, v)."""
    _, prim = _query(scene, ro, rd, t_max, salt, eps, active, ray_id,
                     False, plain)
    t, u, v, prim = exact_hit(scene, ro, rd, prim, eps)
    return Hit(t, prim, u, v)


def trace_any(scene, ro, rd, t_limit, salt=0, eps=1e-5, active=None,
              ray_id=None, plain=False) -> torch.Tensor:
    """True where an accepted triangle occludes (0, t_limit)."""
    _, prim = _query(scene, ro, rd, t_limit, salt, eps, active, ray_id,
                     True, plain)
    return prim >= 0
