"""Ray-scene intersection: triangles on the trace kernels, analytic
spheres and cones layered over them in torch.

Counterpart of ``gi_raytracer_tpu.ops.intersect`` on its Pallas route:
a query goes through the dense trace (``cuda_intersect.prim_query``, K2)
or the superchunk trace (``cuda_stream.prim_query_stream``, K4), as
``routes.trace`` decides; each is the CUDA kernel on the card and its
plain version on the CPU.  The exact Moller-Trumbore (t, u, v) of the
winner is recomputed here.  Spheres and cones are few, so
each query then tests them densely (``_sphere_pass``, ``_cone_pass``): a
prim wins where its t is below the best so far and its stochastic-alpha
draw, keyed on the global ray id and its prim id (T + i for sphere i,
T + S + i for cone i), accepts it.  Sphere and cone lanes carry u = v = 0.

``plain=True`` runs the trace's plain version on any device (the card's
comparison runs use it); nothing on the render path passes it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import routes, telemetry
from ..sampling.rng import hash_u01
from ..scene.types import derived
from . import cuda_intersect as ci
from . import cuda_stream as cs


class Hit(NamedTuple):
    t: torch.Tensor        # (R,) hit distance (inf = miss)
    prim: torch.Tensor     # (R,) int32: triangle id, T + sphere id,
                           #   T + S + cone id, -1 miss
    u: torch.Tensor        # (R,) barycentric u (0 for spheres and cones)
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


def _rotate(m, x):
    """``m @ x`` over the last axes: (..., 3, 3) by (..., 3)."""
    return torch.einsum("...ij,...j->...i", m, x)


def ray_sphere(ro, rd, center, rad):
    """Analytic sphere test, nearest positive root.  Returns (t, ok)."""
    oc = ro - center
    b = torch.sum(rd * oc, -1)
    r = b * b - torch.sum(oc * oc, -1) + rad * rad
    ok = r >= 0
    sr = torch.sqrt(torch.where(ok, r, 0.0))
    t1 = -b - sr
    t2 = -b + sr
    t = torch.where(t1 > 0, t1, t2)
    ok = ok & (t > 0)
    return torch.where(ok, t, torch.inf), ok


def ray_cone(ro, rd, pos, rad, height, w2l):
    """Finite-cone test in the cone's frame (ro/rd broadcast against the
    leading cone dims; w2l (..., 3, 3)).  Keeps the nearer root whose
    local z lies in [0, height], else the farther one.  Returns (t, ok)."""
    o = _rotate(w2l, ro - pos)
    d = _rotate(w2l, rd)
    k = (rad / height) ** 2
    oz_h = o[..., 2] - height
    A = d[..., 0] ** 2 + d[..., 1] ** 2 - k * d[..., 2] ** 2
    B = 2.0 * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1]
               - k * d[..., 2] * oz_h)
    C = o[..., 0] ** 2 + o[..., 1] ** 2 - k * oz_h ** 2
    disc = B * B - 4.0 * A * C
    ok = disc >= 0
    root = torch.sqrt(torch.where(ok, disc, 0.0))
    q = torch.where(B < 0, -0.5 * (B - root), -0.5 * (B + root))
    # guard the degenerate divisions (A == 0: ray parallel to the surface)
    safe_A = torch.where(torch.abs(A) < 1e-30, 1e-30, A)
    safe_q = torch.where(torch.abs(q) < 1e-30, 1e-30, q)
    t1 = q / safe_A
    t2 = C / safe_q
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    ok = ok & (hi > 0)
    near = torch.where(lo > 0, lo, hi)

    def clipped(t):
        z = o[..., 2] + d[..., 2] * t
        return (z >= 0) & (z <= height) & (t > 0)

    t = torch.where(~clipped(near), hi, near)
    ok = ok & clipped(t)
    return torch.where(ok, t, torch.inf), ok


def cone_frame_attrs(point, pos, h, w2l):
    """Cone (normal, uv) at world points from the cone's parameters: the
    local normal cross(dpdu, dpdv) rotated back to world space."""
    p = _rotate(w2l, point - pos)
    two_pi = 2 * torch.pi
    phi = torch.atan2(p[..., 1], p[..., 0])
    phi = torch.where(phi < 0, phi + two_pi, phi)
    u = phi / two_pi
    v = p[..., 2] / h
    dpdu = torch.stack([-two_pi * p[..., 1], two_pi * p[..., 0],
                        torch.zeros_like(u)], -1)
    omv = torch.where(torch.abs(1.0 - v) < 1e-9, 1e-9, 1.0 - v)
    dpdv = torch.stack([-p[..., 0] / omv, -p[..., 1] / omv,
                        torch.broadcast_to(h, u.shape)], -1)
    n_local = torch.linalg.cross(dpdu, dpdv, dim=-1)
    nl = torch.linalg.vector_norm(n_local, dim=-1, keepdim=True)
    n_local = n_local / torch.clamp(nl, min=1e-30)
    n_world = torch.einsum("...ji,...j->...i", w2l, n_local)
    return n_world, torch.stack([u, v], -1)


def cone_attrs(cones, point, prim_local):
    """(normal, uv) at world hit points on cone ``prim_local``."""
    c = prim_local.long()
    return cone_frame_attrs(point, cones.pos[c], cones.height[c],
                            cones.w2l[c])


def _accept_prob(scene, mat_id):
    """P(candidate accepted): opacity, or 1 for refractive (IOR != 1)."""
    m = scene.materials
    mid = mat_id.long()
    return torch.where(m.ior[mid] != 1.0, 1.0, m.opacity[mid])


def _analytic_pass(scene, ro, rd, hit: Hit, ts, ok, mat_id, base, salt,
                   active, t_max, ray_id) -> Hit:
    """Layer the (R, K) analytic candidates ``ts``/``ok`` (prim ids base +
    0..K-1) over ``hit``: accept draw, active and t_max masks, closest of
    them, and it wins where below the current hit."""
    R, K = ts.shape
    dev = ro.device
    p_acc = _accept_prob(scene, mat_id)[None, :]
    rid = (torch.arange(R, device=dev) if ray_id is None
           else ray_id.to(torch.int64) & 0xFFFFFFFF)[:, None]
    pid = (base + torch.arange(K, device=dev))[None, :]
    uni = hash_u01(rid, pid, salt)
    ok = ok & ((uni < p_acc) | (p_acc >= 1.0))
    if active is not None:
        ok = ok & active[:, None]
    if t_max is not None:
        ok = ok & (ts < torch.broadcast_to(
            torch.as_tensor(t_max, device=dev), (R,)).to(ts.dtype)[:, None])
    ts = torch.where(ok, ts, torch.inf)
    j = torch.argmin(ts, dim=1)
    tb = ts.gather(1, j[:, None])[:, 0]
    cur_t = torch.where(hit.prim >= 0, hit.t, torch.inf)
    upd = tb < cur_t
    return Hit(torch.where(upd, tb, hit.t),
               torch.where(upd, (base + j).to(hit.prim.dtype), hit.prim),
               torch.where(upd, 0.0, hit.u), torch.where(upd, 0.0, hit.v))


def _sphere_pass(scene, ro, rd, hit: Hit, salt, active=None, t_max=None,
                 ray_id=None) -> Hit:
    """Dense analytic-sphere closest hit layered over a triangle Hit."""
    if not scene.n_spheres:
        return hit
    sp = scene.spheres
    ts, ok = ray_sphere(ro[:, None, :], rd[:, None, :], sp.pos[None],
                        sp.rad[None])
    return _analytic_pass(scene, ro, rd, hit, ts, ok, sp.mat_id,
                          scene.n_tris, salt, active, t_max, ray_id)


def _cone_pass(scene, ro, rd, hit: Hit, salt, active=None, t_max=None,
               ray_id=None) -> Hit:
    """Dense analytic-cone closest hit layered over an existing Hit."""
    if not scene.n_cones:
        return hit
    cn = scene.cones
    ts, ok = ray_cone(ro[:, None, :], rd[:, None, :], cn.pos[None],
                      cn.rad[None], cn.height[None], cn.w2l[None])
    return _analytic_pass(scene, ro, rd, hit, ts, ok, cn.mat_id,
                          scene.n_tris + scene.n_spheres, salt, active,
                          t_max, ray_id)


def _analytic_passes(scene, ro, rd, hit, salt, active, t_max, ray_id):
    """Both analytic passes over ``hit``, as the span ``trace.analytic``
    (its ``lanes`` and ``prims``); ``hit`` itself without spheres and
    cones."""
    prims = scene.n_spheres + scene.n_cones
    if not prims:
        return hit
    with telemetry.span("trace.analytic", lanes=ro.shape[0], prims=prims):
        hit = _sphere_pass(scene, ro, rd, hit, salt, active, t_max, ray_id)
        return _cone_pass(scene, ro, rd, hit, salt, active, t_max, ray_id)


def trace_tables(scene):
    """The scene's trace tables (``build_tri_features``), kept on the Scene
    object and built again after its tensors change (``types.derived``)."""
    return derived(scene, "_trace_tables", scene.table_sources(),
                   lambda: ci.build_tri_features(scene))


def chunk_boxes(scene):
    """The scene's 128-row chunk boxes (``cuda_intersect.build_boxes`` of
    its trace table), which K2 and K4 walk; kept like ``trace_tables``."""
    return derived(scene, "_chunk_boxes", scene.table_sources(),
                   lambda: ci.build_boxes(scene, trace_tables(scene)[0]
                                          .shape[0], ci.CHUNK_ROWS))


def stream_boxes(scene):
    """The scene's superchunk boxes (``cuda_stream.build_superchunk_boxes``
    of its trace table), kept like ``trace_tables``."""
    return derived(scene, "_stream_boxes", scene.table_sources(),
                   lambda: cs.build_superchunk_boxes(
                       scene, trace_tables(scene)[0].shape[0]))


def _query(scene, ro, rd, t_max, salt, eps, active, ray_id, any_hit, plain):
    R = ro.shape[0]
    dev = ro.device
    if not scene.n_tris:        # spheres and cones only: nothing to walk
        return None, torch.full((R,), -1, dtype=torch.int32, device=dev)
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
    if routes.trace(scene)[0] == "k4":
        fn = cs.prim_query_stream_plain if plain else cs.prim_query_stream
        return fn(feat, accept, stream_boxes(scene), chunk_boxes(scene),
                  *args)
    fn = ci.prim_query_plain if plain else ci.prim_query
    return fn(feat, accept, chunk_boxes(scene), *args)


def trace_closest_rows(scene, rows, ro, rd, t_max=None, salt=0, eps=1e-5,
                       active=None, ray_id=None, plain=False):
    """Closest hit plus the winner's packed shade row (rows = the scene's
    ``build_prim_rows`` table).  The exact (t, u, v) is recomputed from the
    triangle's row; where a sphere or cone wins, its row is gathered
    instead.  Returns (Hit, row (R, PR_W))."""
    def final_row(prim):
        return rows[torch.clamp(prim, 0, rows.shape[0] - 1).long()]

    _, prim = _query(scene, ro, rd, t_max, salt, eps, active, ray_id,
                     False, plain)
    row = final_row(prim)
    t, u, v, ok = ray_triangle(ro, rd, row[:, 0:3], row[:, 3:6], row[:, 6:9],
                               eps)
    m = (prim >= 0) & ok
    hit = Hit(torch.where(m, t, torch.inf), torch.where(m, prim, -1),
              torch.where(m, u, 0.0), torch.where(m, v, 0.0))
    if scene.n_spheres or scene.n_cones:
        hit = _analytic_passes(scene, ro, rd, hit, salt, active, t_max,
                               ray_id)
        row = final_row(hit.prim)
    return hit, row


def exact_hit(scene, ro, rd, prim, eps):
    """Exact (t, u, v, prim) of the kernel-selected triangle; lanes where
    the exact test disagrees with the kernel's accept become misses."""
    tr = scene.tris
    if not tr.count:
        z = torch.zeros_like(ro[:, 0])
        return torch.full_like(z, torch.inf), z, z, prim
    p = torch.clamp(prim, 0, tr.count - 1).long()
    t, u, v, valid = ray_triangle(ro, rd, tr.v0[p], tr.e1[p], tr.e2[p], eps)
    m = (prim >= 0) & valid
    return (torch.where(m, t, torch.inf), torch.where(m, u, 0.0),
            torch.where(m, v, 0.0), torch.where(m, prim, -1))


def trace_closest(scene, ro, rd, t_max=None, salt=0, eps=1e-5, active=None,
                  ray_id=None, plain=False) -> Hit:
    """Closest accepted hit per ray, exact (t, u, v) on triangles."""
    _, prim = _query(scene, ro, rd, t_max, salt, eps, active, ray_id,
                     False, plain)
    t, u, v, prim = exact_hit(scene, ro, rd, prim, eps)
    return _analytic_passes(scene, ro, rd, Hit(t, prim, u, v), salt, active,
                            t_max, ray_id)


def trace_any(scene, ro, rd, t_limit, salt=0, eps=1e-5, active=None,
              ray_id=None, plain=False) -> torch.Tensor:
    """True where an accepted prim occludes (0, t_limit)."""
    _, prim = _query(scene, ro, rd, t_limit, salt, eps, active, ray_id,
                     True, plain)
    if not (scene.n_spheres or scene.n_cones):
        return prim >= 0
    z = torch.zeros_like(ro[:, 0])
    hit = Hit(torch.where(prim >= 0, 0.0, torch.inf), prim, z, z)
    return _analytic_passes(scene, ro, rd, hit, salt, active, t_limit,
                            ray_id).prim >= 0
