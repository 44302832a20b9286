"""The reference's height fog and the fixed-spp frame through it, in plain
torch.

``fog_density``, ``_fog_bounds``, ``_step_offsets``, ``_lane_ids``,
``_march_steps``, ``fog_occludes`` and ``fog_override`` are frozen copies
of ``gi_raytracer_tpu_torch/render/atmosphere.py`` at commit
1541126856b049d70452b3b52d288b6ce70ba0fb (the same code since
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0), but that the march is the
step-by-step loop ``_march_steps`` (every step over every lane), not the
blocked march the program runs: the first scattering step wins either
way.

``_direct_light`` and ``radiance_wave`` are ``integrator``'s frozen wave
(e5c621c, over ``trace`` and ``shading``) with the fog branches of the
program's wave at 1541126: every bounce marches the fog before its
surface (``fog_override``) and every shadow ray before its light
(``fog_occludes``).  ``shadow_fog=False`` skips the shadow rays' march:
the planted fault ``shadow_clear``, the cheapest cut a march kernel
could make.  ``FogFrame`` is ``integrator.Frame`` over this wave; the
frozen modules stay as they are, and no other cell's reference moves.
"""

from __future__ import annotations

import torch

from .config import RenderConfig
from .geom import normalize, random_unit_vec, PI
from .integrator import Frame, PathState
from .precision import lower
from .rng import Purpose, hash_u01
from .shading import build_prim_rows, shade_from_rows, secondary_ray
from .trace import trace_closest_rows, trace_any


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


def _march_steps(scene, cfg: RenderConfig, ro, rd, tmin, tmax, has, salt,
                 ray_id=None):
    """The march one step at a time over every lane: first stochastic
    scattering event along [tmin, tmax].  Returns (scattered (R,),
    t_hit (R,))."""
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
    return _march_steps(scene, cfg, ro, rd, tmin, tmax, has, salt,
                        ray_id=ray_id)[0]


def fog_override(scene, cfg: RenderConfig, ro, rd, t_hit_surface, sx, sy,
                 salt, point, normal, out_dir, f, color, contrib, rough,
                 offset_sign, ray_id=None, active=None):
    """In-scattering override of the surface hit: where the march scatters
    before the surface (rays that miss march nothing: t_cap 0), the bounce
    continues from the fog event in a uniform random direction with f =
    color = contrib = fog color and roughness 1.  The surface normal is
    left untouched.  ``active``: march only these lanes (the rest keep
    their surface values)."""
    t_cap = torch.where(torch.isfinite(t_hit_surface), t_hit_surface, 0.0)
    tmin, tmax, has = _fog_bounds(scene, ro, rd, t_cap)
    if active is not None:
        has = has & active
    scat, t_s = _march_steps(scene, cfg, ro, rd, tmin, tmax, has, salt,
                             ray_id=ray_id)
    fog_col = torch.broadcast_to(scene.fog.color[None, :].to(color.dtype),
                                 color.shape)
    m = scat[:, None]
    return (torch.where(m, ro + t_s[:, None] * rd, point), normal,
            torch.where(m, random_unit_vec(sx, sy), out_dir),
            torch.where(m, fog_col, f), torch.where(m, fog_col, color),
            torch.where(m, fog_col, contrib), torch.where(scat, 1.0, rough),
            offset_sign)


def _direct_light(scene, cfg: RenderConfig, point, normal, rough, u_light,
                  salt, active=None, ray_id=None, shadow_fog=True):
    """One shadow ray per light per bounce toward a uniform sphere point on
    the light; lights are summed.  A shadow ray is also occluded where its
    march scatters before the light (``shadow_fog``; marched on ``active``
    lanes only)."""
    L = scene.lights.count
    acc = torch.zeros_like(point)
    bias = cfg.shadow_bias
    for li in range(L):
        lpos = scene.lights.pos[li]
        lcol = scene.lights.col[li]
        lrad = scene.lights.rad[li]
        ux, uy = u_light[2 * li], u_light[2 * li + 1]
        lp = lpos[None, :] + lrad * random_unit_vec(ux, uy)
        so = point + bias * normal
        ldir = lp - so
        t_lim = torch.sqrt(torch.sum(ldir * ldir, -1)) - bias
        occ = trace_any(scene, so, normalize(ldir), t_lim,
                        salt=(salt + 7919 * (li + 1)) & 0xFFFFFFFF,
                        active=active, ray_id=ray_id)
        if shadow_fog:
            occ = occ | fog_occludes(
                scene, cfg, so, normalize(ldir), t_lim,
                (salt + 104729 * (li + 1)) & 0xFFFFFFFF, ray_id=ray_id,
                active=active)
        to_l = lpos[None, :] - point
        d = torch.clamp(torch.sum(normal * normalize(to_l), -1), min=0.0)
        d_pos = d > 0
        d_safe = torch.where(d_pos, d, 1.0)
        l_term = torch.where(
            d_pos, d_safe ** (1.0 / torch.clamp(rough, min=1e-12)), 0.0)
        hfrac = 1.0 / (PI * torch.sum(to_l * to_l, -1))
        acc = acc + torch.where(occ[:, None], 0.0,
                                lcol[None, :] * (l_term * hfrac)[:, None])
    return acc


def radiance_wave(scene, cfg: RenderConfig, ro, rd, sx_all, sy_all,
                  lane_ids, prim_rows=None, lane_rays=None,
                  shadow_fog=True):
    """Trace a wave of a fog scene through ``cfg.max_depth`` bounces.
    Returns ((R,3) radiance, (n_closest, n_shadow)); ``lane_rays`` (an
    (R,) int64 tensor) gets each lane's closest plus shadow rays.  Lane
    ids are ``lane_ids``."""
    R = ro.shape[0]
    dev = ro.device
    dt = ro.dtype
    if not scene.has_fog:
        raise ValueError("the fog wave needs a scene with fog")
    L = scene.lights.count
    rows = prim_rows if prim_rows is not None else build_prim_rows(scene)
    ambient = torch.tensor(cfg.ambient, dtype=dt, device=dev)
    lane = lane_ids.to(torch.int64) & 0xFFFFFFFF

    def u(purpose, salt):
        # the high-bit tag keeps decision streams disjoint from the
        # traversal's alpha streams
        return hash_u01(lane, 0x80000000 ^ int(purpose), salt).to(dt)

    st = PathState(ro, rd, torch.ones((R, 3), dtype=dt, device=dev),
                   torch.ones((R, 3), dtype=dt, device=dev),
                   torch.zeros((R, 3), dtype=dt, device=dev),
                   torch.ones(R, dtype=torch.bool, device=dev),
                   torch.zeros((), dtype=torch.int64, device=dev),
                   torch.zeros((), dtype=torch.int64, device=dev))
    for depth in range(cfg.max_depth):
        salt = (depth * 31337) & 0xFFFFFFFF
        u_rr = u(Purpose.RUSSIAN_ROULETTE, salt)
        u_op = u(Purpose.RAY_TYPE_OPACITY, salt)
        u_fs = u(Purpose.RAY_TYPE_FRESNEL, salt)
        u_light = [u(int(Purpose.LIGHT_POINT_X) + 16 * li + axis, salt)
                   for li in range(L) for axis in range(2)]

        hit, row = trace_closest_rows(scene, rows, st.ro, st.rd, salt=salt,
                                      eps=cfg.epsilon, active=st.alive,
                                      ray_id=lane)
        sh = shade_from_rows(scene, row, st.ro, st.rd, hit.t, hit.prim,
                             hit.u, hit.v)
        sec = secondary_ray(st.rd, sh.normal, sh.color, sh.alpha, sh.rough,
                            sh.ior, sx_all[depth], sy_all[depth], u_op, u_fs,
                            st.contrib)
        point, normal, out_dir, f, color, contrib, rough, offset_sign = (
            sh.point, sec.normal, sec.dir, sec.f, sh.color, sec.contrib,
            sh.rough, sec.offset_sign)
        (point, normal, out_dir, f, color, contrib, rough,
         offset_sign) = fog_override(
            scene, cfg, st.ro, st.rd, hit.t, sx_all[depth], sy_all[depth],
            salt, point, normal, out_dir, f, color, contrib, rough,
            offset_sign, ray_id=lane, active=st.alive)
        valid = st.alive & sh.valid
        if lane_rays is not None:
            lane_rays += st.alive.long() + L * valid.long()
        i_direct = _direct_light(scene, cfg, point, normal, rough, u_light,
                                 salt, active=valid, ray_id=lane,
                                 shadow_fog=shadow_fog)
        caustic = torch.zeros_like(color)

        q = torch.max(contrib, dim=-1).values
        if depth <= cfg.min_depth:
            survive = torch.ones_like(valid)
            boost = torch.ones_like(q)
        else:
            survive = u_rr < q
            boost = 1.0 / torch.clamp(q, min=1e-12)

        lum = st.radiance
        lum = lum + torch.where(valid[:, None],
                                st.throughput * (color * i_direct), 0.0)
        lum = lum + torch.where((valid & survive)[:, None],
                                st.throughput * (sh.emissive
                                                 + color * caustic), 0.0)
        lum = lum + torch.where((st.alive & ~sh.valid)[:, None],
                                st.throughput * ambient[None, :], 0.0)
        st = PathState(
            lower(point + (offset_sign * cfg.shadow_bias)[:, None] * normal),
            lower(out_dir), lower(st.throughput * f * boost[:, None]),
            contrib, lower(lum), valid & survive,
            st.n_closest + st.alive.sum(), st.n_shadow + L * valid.sum())
    return st.radiance, (st.n_closest, st.n_shadow)


class FogFrame(Frame):
    """``integrator.Frame`` of a fog scene, no photon map:
    ``render_blocks`` renders the blocks it is given through the fog wave.
    ``shadow_fog=False``: the fault ``shadow_clear``."""

    def __init__(self, scene, camera, config: RenderConfig, width: int,
                 height: int, shadow_fog: bool = True):
        super().__init__(scene, camera, config, width, height)
        self.shadow_fog = shadow_fog

    def wave_lanes(self, ro, rd, sx_all, sy_all, lane_ids):
        """One wave of these lanes: ((R, 3) radiance, (R,) closest plus
        shadow rays of each lane)."""
        rays = torch.zeros(ro.shape[0], dtype=torch.int64, device=ro.device)
        c, _ = radiance_wave(self.scene, self.cfg, ro, rd, sx_all, sy_all,
                             lane_ids, self.rows, rays, self.shadow_fog)
        return c, rays
