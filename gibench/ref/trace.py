"""The reference's ray-scene trace: exact Moller-Trumbore over every
triangle a ray can reach, in plain torch.

The triangles are grouped into chunks of ``CHUNK`` in Morton order of
their centroids (the yardstick's own order, not the program's BVH); a
ray tests every triangle of every chunk whose padded box it enters before
its limit, and keeps the hit of the smallest key, the lowest triangle id
on an exact tie.  The box cull only skips chunks a ray cannot hit, so the
answer is that of testing every triangle.

The key is the configurations' stated hit order: t_num x 1/bf16(|det|),
Moller-Trumbore's numerator of t (made positive) times the float32
reciprocal of |det| rounded to bfloat16 (round to nearest even).  It
orders the hits and is held against a ray's limit; the winner's exact t
is then recomputed.  Two triangles that meet at an edge give the same
exact t there but keys apart by up to 2^-9 of it, so the key, not t,
decides which of them a ray on the edge hits.  ``ray_triangle`` and the cone
attributes are frozen copies of ``gi_raytracer_tpu_torch/ops/intersect.py``
at commit e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0.

Every material of the benchmark's scenes accepts every hit (opacity 1 or
a refractive IOR), so there is no stochastic alpha; a scene with analytic
primitives or a cut-out material is refused.  ``precision.lower`` rounds
the rays in the control.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .precision import lower

CHUNK = 128
# (rays x chunks) box tests, and (ray, chunk) pairs, per block
BOX_BLOCK = 1 << 24
PAIR_BLOCK = 1 << 15
BOX_PAD = 1e-4
# a key below a limit has its exact t below KEY_SLACK times the limit
# (bfloat16 rounds |det| by at most 2^-9 of it), so the chunk cull keeps
# every chunk such a hit can lie in
KEY_SLACK = 1.0 + 2.0 ** -8


class Hit(NamedTuple):
    t: torch.Tensor        # (R,) hit distance (inf = miss)
    prim: torch.Tensor     # (R,) int32 triangle id, -1 miss
    u: torch.Tensor        # (R,) barycentric u
    v: torch.Tensor        # (R,) barycentric v


def ray_triangle_keyed(ro, rd, v0, e1, e2, eps):
    """Branchless Moller-Trumbore with the hit order's key.  Returns
    (t, u, v, ok, key)."""
    p = torch.linalg.cross(rd, e2, dim=-1)
    det = torch.sum(e1 * p, -1)
    ok = torch.abs(det) >= eps
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = ro - v0
    u = torch.sum(tvec * p, -1) * inv_det
    q = torch.linalg.cross(tvec, e1, dim=-1)
    v = torch.sum(rd * q, -1) * inv_det
    t_num = torch.sum(e2 * q, -1)
    t = t_num * inv_det
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    ad = torch.clamp(torch.abs(det), min=1e-30)
    key = torch.abs(t_num) * (1.0 / ad.to(torch.bfloat16).to(ad.dtype))
    return t, u, v, ok, key


def ray_triangle(ro, rd, v0, e1, e2, eps):
    """Branchless Moller-Trumbore.  Returns (t, u, v, ok)."""
    return ray_triangle_keyed(ro, rd, v0, e1, e2, eps)[:4]


def _rotate(m, x):
    """``m @ x`` over the last axes: (..., 3, 3) by (..., 3)."""
    return torch.einsum("...ij,...j->...i", m, x)


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


def _morton(c):
    """30-bit Morton codes of (N, 3) points scaled to [0, 1]."""
    q = torch.clamp((c * 1023.0).long(), 0, 1023)
    code = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


class Chunks(NamedTuple):
    lo: torch.Tensor       # (C, 3) padded chunk box
    hi: torch.Tensor
    tri: torch.Tensor      # (C, CHUNK) triangle ids, -1 past the end


def chunks(scene) -> Chunks:
    """The scene's Morton-ordered chunks, kept on the scene object."""
    got = getattr(scene, "_ref_chunks", None)
    if got is not None:
        return got
    tr = scene.tris
    T = tr.count
    v0 = tr.v0
    v1, v2 = v0 + tr.e1, v0 + tr.e2
    vmin = torch.minimum(torch.minimum(v0, v1), v2)
    vmax = torch.maximum(torch.maximum(v0, v1), v2)
    cen = (vmin + vmax) * 0.5
    lo, hi = cen.min(0).values, cen.max(0).values
    order = torch.argsort(_morton((cen - lo) / torch.clamp(hi - lo,
                                                           min=1e-30)))
    C = (T + CHUNK - 1) // CHUNK
    tri = torch.full((C * CHUNK,), -1, dtype=torch.int64, device=v0.device)
    tri[:T] = order
    tri = tri.view(C, CHUNK)
    safe = torch.clamp(tri, min=0)
    cmin = torch.where((tri >= 0)[..., None], vmin[safe], torch.inf).amin(1)
    cmax = torch.where((tri >= 0)[..., None], vmax[safe], -torch.inf).amax(1)
    pad = BOX_PAD * (1.0 + cmax.abs().amax(1, keepdim=True))
    got = Chunks(cmin - pad, cmax + pad, tri)
    object.__setattr__(scene, "_ref_chunks", got)
    return got


def _check(scene):
    if scene.n_spheres or scene.n_cones:
        raise ValueError("the reference trace has no analytic primitives")
    if not scene.all_opaque:
        raise ValueError("the reference trace has no stochastic alpha")


def _nearest(scene, ro, rd, t_lim, eps, lanes):
    """(key, prim) of the accepted triangle of the smallest key below
    ``t_lim`` for the rays ``lanes`` (inf, -1 for none)."""
    ch = chunks(scene)
    tr = scene.tris
    C = ch.tri.shape[0]
    dev = ro.device
    n = lanes.shape[0]
    none = torch.iinfo(torch.int64).max
    best_t = torch.full((n,), torch.inf, dtype=ro.dtype, device=dev)
    best_p = torch.full((n,), none, dtype=torch.int64, device=dev)
    step = max(1, BOX_BLOCK // max(C, 1))
    for s in range(0, n, step):
        sel = torch.arange(s, min(s + step, n), device=dev)
        o, d = ro[lanes[sel]], rd[lanes[sel]]
        tl = t_lim[lanes[sel]]
        d_safe = torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
        inv = 1.0 / d_safe
        t0 = (ch.lo[None] - o[:, None]) * inv[:, None]
        t1 = (ch.hi[None] - o[:, None]) * inv[:, None]
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        ray_i, chunk_i = torch.nonzero(
            (tmax >= torch.clamp(tmin, min=0.0))
            & (tmin < tl[:, None] * KEY_SLACK),
            as_tuple=True)
        pair_t, pair_p = [], []
        for a in range(0, ray_i.shape[0], PAIR_BLOCK):
            ri = ray_i[a:a + PAIR_BLOCK]
            tri = ch.tri[chunk_i[a:a + PAIR_BLOCK]]            # (P, CHUNK)
            safe = torch.clamp(tri, min=0)
            _, _, _, ok, t = ray_triangle_keyed(
                o[ri][:, None], d[ri][:, None], tr.v0[safe], tr.e1[safe],
                tr.e2[safe], eps)
            ok = ok & (tri >= 0) & (t < tl[ri][:, None])
            t = torch.where(ok, t, torch.inf)
            tp = t.amin(1)
            pair_t.append(tp)
            pair_p.append(torch.where(t == tp[:, None], tri, none).amin(1))
        if not pair_t:
            continue
        gi = sel[ray_i]
        tp, pp = torch.cat(pair_t), torch.cat(pair_p)
        best_t.scatter_reduce_(0, gi, tp, "amin")
        win = torch.isfinite(tp) & (tp == best_t[gi])
        best_p.scatter_reduce_(0, gi[win], pp[win], "amin")
    return best_t, torch.where(best_p == none, -1, best_p)


def _query(scene, ro, rd, t_max, eps, active):
    """(R,) int64 prim of the accepted triangle of the smallest key below
    ``t_max``, -1 for none."""
    _check(scene)
    ro, rd = lower(ro.detach()), lower(rd.detach())
    R = ro.shape[0]
    dev = ro.device
    tl = (torch.full((R,), torch.inf, dtype=ro.dtype, device=dev)
          if t_max is None else torch.broadcast_to(
              torch.as_tensor(t_max, device=dev), (R,)).to(ro.dtype))
    act = (torch.ones(R, dtype=torch.bool, device=dev) if active is None
           else active)
    prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
    lanes = torch.nonzero(act).squeeze(1)
    if lanes.numel() and scene.n_tris:
        _, p = _nearest(scene, ro, rd, tl.detach(), eps, lanes)
        prim[lanes] = p
    return prim


def exact_hit(scene, ro, rd, prim, eps):
    """Exact (t, u, v, prim) of triangle ``prim``; -1 stays a miss."""
    tr = scene.tris
    p = torch.clamp(prim, 0, max(tr.count - 1, 0))
    t, u, v, valid = ray_triangle(ro, rd, tr.v0[p], tr.e1[p], tr.e2[p], eps)
    m = (prim >= 0) & valid
    return Hit(torch.where(m, t, torch.inf), torch.where(m, prim, -1).int(),
               torch.where(m, u, 0.0), torch.where(m, v, 0.0))


def trace_closest(scene, ro, rd, t_max=None, salt=0, eps=1e-5, active=None,
                  ray_id=None) -> Hit:
    """Closest hit per ray, exact (t, u v).  ``salt`` and ``ray_id`` key
    the program's stochastic alpha, which these scenes never draw."""
    return exact_hit(scene, ro, rd, _query(scene, ro, rd, t_max, eps,
                                           active), eps)


def trace_closest_rows(scene, rows, ro, rd, t_max=None, salt=0, eps=1e-5,
                       active=None, ray_id=None):
    """Closest hit plus the winner's packed shade row (``rows`` the
    scene's ``shading.build_prim_rows`` table): (Hit, row (R, PR_W))."""
    hit = trace_closest(scene, ro, rd, t_max, salt, eps, active, ray_id)
    return hit, rows[torch.clamp(hit.prim, 0, rows.shape[0] - 1).long()]


def trace_any(scene, ro, rd, t_limit, salt=0, eps=1e-5, active=None,
              ray_id=None) -> torch.Tensor:
    """True where a triangle occludes (0, t_limit)."""
    return _query(scene, ro, rd, t_limit, eps, active) >= 0
