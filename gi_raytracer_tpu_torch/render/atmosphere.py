"""Atmospheric height fog: density field and stochastic raymarch.

Counterpart of ``gi_raytracer_tpu.render.atmosphere``.  The density at p
is ``d * noise(p)^7 * ((ymax - p.y)/size_y)^2`` with the noise trilinear
in the fog's random grid.  The march takes fixed steps of
``cfg.raymarch_stepsize`` from the fog box's entry (plus the shadow bias);
at step i the ray scatters when ``hash_u01(ray id, i, salt)`` is below the
local density, and the first scattering step wins.

The JAX package runs the march as a loop of single steps.  :func:`march`
takes the route ``routes.fog_march`` names: on the card one launch of the
fog march kernel (``ops.cuda_fog``), a thread a lane walking to its first
scattering step; elsewhere :func:`_march`, in blocks of ``MARCH_BLOCK``
steps as (lanes, steps) tensors over the lanes that still march: a lane
stops at its first scattering step, and the march ends when no lane has a
step left before its ``tmax``.  The outcome is the same, since a later
step can never take the place of an earlier one.  ``_march_steps`` is the
step-by-step loop, the plain version the card tests hold both against.
"""

from __future__ import annotations

import torch

from .. import routes, telemetry
from ..config import RenderConfig
from ..ops import _cuda, cuda_fog
from ..sampling.rng import hash_u01
from .geom import random_unit_vec

MARCH_BLOCK = 32      # steps marched per block


def fog_density(scene, p: torch.Tensor) -> torch.Tensor:
    """Density (scatter probability per step) at points p (..., 3)."""
    fog = scene.fog
    bmin, bmax = fog.bbox_min, fog.bbox_max
    size = bmax - bmin
    inside = torch.all((p >= bmin) & (p <= bmax), dim=-1)
    g = fog.grid
    nx, ny, nz = g.shape
    rel = p - bmin
    # unit-sized grid cells, clamped into the grid
    gx = torch.clamp(rel[..., 0], 0.0, nx - 1.001)
    gy = torch.clamp(rel[..., 1], 0.0, ny - 1.001)
    gz = torch.clamp(rel[..., 2], 0.0, nz - 1.001)
    ix = gx.to(torch.int64)
    iy = gy.to(torch.int64)
    iz = gz.to(torch.int64)
    dx, dy, dz = gx - ix, gy - iy, gz - iz

    def at(ox, oy, oz):
        return g[torch.clamp(ix + ox, max=nx - 1),
                 torch.clamp(iy + oy, max=ny - 1),
                 torch.clamp(iz + oz, max=nz - 1)]

    c00 = at(0, 0, 0) * (1 - dx) + at(1, 0, 0) * dx
    c01 = at(0, 0, 1) * (1 - dx) + at(1, 0, 1) * dx
    c10 = at(0, 1, 0) * (1 - dx) + at(1, 1, 0) * dx
    c11 = at(0, 1, 1) * (1 - dx) + at(1, 1, 1) * dx
    c0 = c00 * (1 - dy) + c10 * dy
    c1 = c01 * (1 - dy) + c11 * dy
    noise = (c0 * (1 - dz) + c1 * dz) ** 7
    falloff = ((bmax[1] - p[..., 1]) / size[1]) ** 2
    return torch.where(inside, fog.density * noise * falloff, 0.0)


def _fog_bounds(scene, ro, rd, t_cap):
    """Overlap of the ray segment [0, t_cap] with the fog box:
    (tmin, tmax, has)."""
    fog = scene.fog
    tiny = 1e-12
    safe = torch.where(torch.abs(rd) < tiny,
                       torch.where(rd < 0, -tiny, tiny), rd)
    inv = 1.0 / safe
    ta = (fog.bbox_min[None, :] - ro) * inv
    tb = (fog.bbox_max[None, :] - ro) * inv
    tn = torch.max(torch.minimum(ta, tb), -1).values
    tf = torch.min(torch.maximum(ta, tb), -1).values
    tmin = torch.clamp(tn, min=0.0)
    tmax = torch.minimum(tf, t_cap)
    return tmin, tmax, (tf >= tn) & (tmax > tmin)


def _step_offsets(cfg, i, dtype):
    """i * step for step indices ``i``, rounded once into ``dtype``."""
    return (i.to(torch.float64) * cfg.raymarch_stepsize).to(dtype)


def _lane_ids(ro, ray_id):
    return (torch.arange(ro.shape[0], device=ro.device) if ray_id is None
            else ray_id.to(torch.int64) & 0xFFFFFFFF)


def _march(scene, cfg: RenderConfig, ro, rd, tmin, tmax, has, salt,
           ray_id=None, use="scatter"):
    """First stochastic scattering event along [tmin, tmax], in blocks of
    steps over the lanes still marching.  ``ray_id``: the global lane ids
    keying the scatter draws.  Returns (scattered (R,), t_hit (R,)).

    The march is one ``fog.march`` span: its ``use`` (``"shadow"`` or
    ``"scatter"``), the ``lanes`` entering it, the ``blocks`` it ran and
    its ``lane_steps`` (each block's lanes times its steps, summed), all
    sizes the host holds; a block waits for the host five times, each a
    ``fog.block`` sync."""
    _cuda.plain_calls["fog_march"] += 1
    R = ro.shape[0]
    dev = ro.device
    rid = _lane_ids(ro, ray_id)
    t0 = tmin + cfg.shadow_bias
    found = torch.zeros(R, dtype=torch.bool, device=dev)
    t_hit = torch.zeros(R, dtype=ro.dtype, device=dev)
    n_steps = int(cfg.raymarch_max_steps)
    with telemetry.span("fog.march", use=use, route="torch") as sp:
        with telemetry.sync("fog.lanes"):
            lanes = torch.nonzero(has & (t0 < tmax)).squeeze(1)
        entering, blocks, lane_steps = lanes.numel(), 0, 0
        for i0 in range(0, n_steps, MARCH_BLOCK):
            if not lanes.numel():
                break
            i = torch.arange(i0, min(i0 + MARCH_BLOCK, n_steps), device=dev)
            blocks += 1
            lane_steps += lanes.numel() * i.numel()
            t = t0[lanes, None] + _step_offsets(cfg, i, ro.dtype)[None, :]
            p = ro[lanes, None, :] + t[..., None] * rd[lanes, None, :]
            u = hash_u01(rid[lanes, None], i[None, :], salt)
            scat = (t < tmax[lanes, None]) & (u < fog_density(scene, p))
            hit_any = scat.any(1)
            first = torch.argmax(scat.to(torch.uint8), dim=1)
            with telemetry.sync("fog.block"):
                won = lanes[hit_any]
            with telemetry.sync("fog.block"):
                found[won] = True
            with telemetry.sync("fog.block"):
                step = first[hit_any]
            with telemetry.sync("fog.block"):
                t_hit[won] = t[hit_any, step]
            # lanes go on while unscattered with a step left before tmax
            t_next = t0[lanes] + _step_offsets(cfg, i[-1:] + 1, ro.dtype)
            with telemetry.sync("fog.block"):
                lanes = lanes[~hit_any & (t_next < tmax[lanes])]
        if sp is not None:
            sp.attrs.update(lanes=entering, blocks=blocks,
                            lane_steps=lane_steps)
    return found, t_hit


def march(scene, cfg: RenderConfig, ro, rd, tmin, tmax, has, salt,
          ray_id=None, use="scatter"):
    """The march on the route ``routes.fog_march`` names: the kernel, or
    :func:`_march` (the same arguments and results).  On the kernel's
    route the ``fog.march`` span's ``route`` is ``"kernel"`` and its
    ``lanes``, ``blocks`` and ``lane_steps`` are counted on the card as
    :func:`_march` counts them; the march waits for nothing, and t_hit is
    rebuilt from the scattering step in torch, so a gradient through the
    rays reaches it as through :func:`_march`'s."""
    route, _ = routes.fog_march(scene, cfg, ro, rd)
    if route == "torch":
        return _march(scene, cfg, ro, rd, tmin, tmax, has, salt,
                      ray_id=ray_id, use=use)
    with telemetry.span("fog.march", use=use, route=route) as sp:
        t0 = tmin + cfg.shadow_bias
        found, step = cuda_fog.march(
            scene.fog, ro, rd, t0, tmax, has, ray_id,
            salt, cfg.raymarch_stepsize, int(cfg.raymarch_max_steps),
            MARCH_BLOCK,
            telemetry.counts_ptr(sp, "lanes", "lane_steps", "blocks"))
        t_hit = torch.where(found, t0 + _step_offsets(cfg, step, ro.dtype),
                            0.0)
    return found, t_hit


def _march_steps(scene, cfg: RenderConfig, ro, rd, tmin, tmax, has, salt,
                 ray_id=None):
    """The march one step at a time over every lane: the plain version of
    :func:`_march`."""
    R = ro.shape[0]
    rid = _lane_ids(ro, ray_id)
    found = torch.zeros(R, dtype=torch.bool, device=ro.device)
    t_hit = torch.zeros(R, dtype=ro.dtype, device=ro.device)
    offsets = _step_offsets(cfg, torch.arange(int(cfg.raymarch_max_steps),
                                              device=ro.device), ro.dtype)
    for i in range(int(cfg.raymarch_max_steps)):
        t = tmin + cfg.shadow_bias + offsets[i]
        dens = fog_density(scene, ro + t[:, None] * rd)
        u = hash_u01(rid, i, salt)
        scat = has & (t < tmax) & (u < dens) & ~found
        found = found | scat
        t_hit = torch.where(scat, t, t_hit)
    return found, t_hit


def fog_occludes(scene, cfg: RenderConfig, ro, rd, t_lim, salt,
                 ray_id=None, active=None):
    """Shadow-ray fog occlusion: True where the march scatters before
    ``t_lim``.  ``active``: march only these lanes (the rest stay False)."""
    tmin, tmax, has = _fog_bounds(scene, ro, rd, t_lim)
    if active is not None:
        has = has & active
    return march(scene, cfg, ro, rd, tmin, tmax, has, salt,
                 ray_id=ray_id, use="shadow")[0]


def fog_override(scene, cfg: RenderConfig, ro, rd, t_hit_surface, sx, sy,
                 salt, point, normal, out_dir, f, color, contrib, rough,
                 offset_sign, ray_id=None, active=None):
    """In-scattering override of the surface hit: where the march scatters
    before the surface (rays that miss march nothing: t_cap 0), the bounce
    continues from the fog event in a uniform random direction with f =
    color = contrib = fog color and roughness 1.  The surface normal is
    left untouched, as in the reference.  ``active``: march only these
    lanes (the rest keep their surface values)."""
    t_cap = torch.where(torch.isfinite(t_hit_surface), t_hit_surface, 0.0)
    tmin, tmax, has = _fog_bounds(scene, ro, rd, t_cap)
    if active is not None:
        has = has & active
    scat, t_s = march(scene, cfg, ro, rd, tmin, tmax, has, salt,
                      ray_id=ray_id)
    fog_col = torch.broadcast_to(scene.fog.color[None, :].to(color.dtype),
                                 color.shape)
    m = scat[:, None]
    return (torch.where(m, ro + t_s[:, None] * rd, point), normal,
            torch.where(m, random_unit_vec(sx, sy), out_dir),
            torch.where(m, fog_col, f), torch.where(m, fog_col, color),
            torch.where(m, fog_col, contrib), torch.where(scat, 1.0, rough),
            offset_sign)
