"""The reference's trace of scenes with analytic spheres and cones, and the
photon pass and staged wave over it, in plain torch.

The triangles are traced as ``trace`` traces them (the stated hit order,
exact t recomputed); spheres and cones are few, so every ray then tests
each of them densely: a sphere (nearest positive root) or a finite cone
(in the cone's frame) wins where its t lies below the best so far,
spheres first, then cones.  ``ray_sphere``, ``ray_cone`` and the passes
are frozen copies of ``gi_raytracer_tpu_torch/ops/intersect.py`` at
commit 08137f7bb5cc449304fb11a330e0c750f933f967 (unchanged since
e5c621c), less the stochastic-alpha draw: as in ``trace``, a scene with
a cut-out material is refused, so every candidate is accepted.

``trace`` itself refuses analytic primitives and ``photon`` and
``integrator`` call it by name.  ``radiance_wave`` and ``trace_photons``
here are those frozen functions, code and defaults unchanged, bound to
this module's traces in place of ``trace``'s (``_rebound``): the frozen
modules stay as they are, and no other cell's reference moves.
"""

from __future__ import annotations

import types

import torch

from . import integrator, photon
from .precision import lower
from .trace import Hit, _nearest, _rotate, exact_hit


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


def _analytic_pass(hit: Hit, ts, ok, base, active, t_max) -> Hit:
    """Layer the (R, K) analytic candidates ``ts``/``ok`` (prim ids base +
    0..K-1) over ``hit``: active and t_max masks, closest of them, and it
    wins where below the current hit."""
    R = ts.shape[0]
    if active is not None:
        ok = ok & active[:, None]
    if t_max is not None:
        lim = torch.broadcast_to(torch.as_tensor(t_max, device=ts.device),
                                 (R,)).to(ts.dtype)
        ok = ok & (ts < lim[:, None])
    ts = torch.where(ok, ts, torch.inf)
    j = torch.argmin(ts, dim=1)
    tb = ts.gather(1, j[:, None])[:, 0]
    cur_t = torch.where(hit.prim >= 0, hit.t, torch.inf)
    upd = tb < cur_t
    return Hit(torch.where(upd, tb, hit.t),
               torch.where(upd, (base + j).to(hit.prim.dtype), hit.prim),
               torch.where(upd, 0.0, hit.u), torch.where(upd, 0.0, hit.v))


def analytic_passes(scene, ro, rd, hit: Hit, active=None,
                    t_max=None) -> Hit:
    """The sphere pass, then the cone pass, layered over ``hit``."""
    if scene.n_spheres:
        sp = scene.spheres
        ts, ok = ray_sphere(ro[:, None, :], rd[:, None, :], sp.pos[None],
                            sp.rad[None])
        hit = _analytic_pass(hit, ts, ok, scene.n_tris, active, t_max)
    if scene.n_cones:
        cn = scene.cones
        ts, ok = ray_cone(ro[:, None, :], rd[:, None, :], cn.pos[None],
                          cn.rad[None], cn.height[None], cn.w2l[None])
        hit = _analytic_pass(hit, ts, ok, scene.n_tris + scene.n_spheres,
                             active, t_max)
    return hit


def _query(scene, ro, rd, t_max, eps, active):
    """``trace._query`` without its refusal of analytic primitives: (R,)
    int64 prim of the accepted triangle of the smallest key below
    ``t_max``, -1 for none."""
    if not scene.all_opaque:
        raise ValueError("the reference trace has no stochastic alpha")
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


def trace_closest(scene, ro, rd, t_max=None, salt=0, eps=1e-5, active=None,
                  ray_id=None) -> Hit:
    """Closest hit per ray over triangles, spheres and cones.  ``salt`` and
    ``ray_id`` key the program's stochastic alpha, which these scenes
    never draw."""
    hit = exact_hit(scene, ro, rd, _query(scene, ro, rd, t_max, eps,
                                          active), eps)
    return analytic_passes(scene, ro, rd, hit, active, t_max)


def trace_closest_rows(scene, rows, ro, rd, t_max=None, salt=0, eps=1e-5,
                       active=None, ray_id=None):
    """Closest hit plus the winner's packed shade row: (Hit, row)."""
    hit = trace_closest(scene, ro, rd, t_max, salt, eps, active, ray_id)
    return hit, rows[torch.clamp(hit.prim, 0, rows.shape[0] - 1).long()]


def trace_any(scene, ro, rd, t_limit, salt=0, eps=1e-5, active=None,
              ray_id=None) -> torch.Tensor:
    """True where a triangle's key or an analytic prim's t lies below
    ``t_limit``."""
    prim = _query(scene, ro, rd, t_limit, eps, active)
    z = torch.zeros_like(ro[:, 0])
    hit = Hit(torch.where(prim >= 0, 0.0, torch.inf), prim, z, z)
    return analytic_passes(scene, ro, rd, hit, active, t_limit).prim >= 0


def _rebound(module, names, **given) -> types.SimpleNamespace:
    """The functions ``names`` of a frozen ``module``, code and defaults
    unchanged, run with ``given`` in place of the module's own globals of
    those names (and calling each other's copies)."""
    g = dict(vars(module), **given)
    out = {}
    for n in names:
        f = getattr(module, n)
        c = types.FunctionType(f.__code__, g, f.__name__, f.__defaults__,
                               f.__closure__)
        c.__kwdefaults__, c.__doc__ = f.__kwdefaults__, f.__doc__
        g[n] = out[n] = c
    return types.SimpleNamespace(**out)


_wave = _rebound(integrator, ("_direct_light", "radiance_wave"),
                 trace_closest_rows=trace_closest_rows, trace_any=trace_any)
_pass = _rebound(photon, ("_emit_attempts", "_emit_chunk", "_trace_photons",
                          "trace_photons"), trace_closest=trace_closest)

# ``integrator.radiance_wave`` and ``photon.trace_photons`` over this trace
radiance_wave = _wave.radiance_wave
trace_photons = _pass.trace_photons
