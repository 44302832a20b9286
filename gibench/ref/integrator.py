"""Frozen copy of the staged wave and the frame of
``gi_raytracer_tpu_torch/render/integrator.py`` at commit
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0, without the megakernel's
dispatch, fog, bands and the adaptive block waves.  Its traces are the
reference's own (``trace``) and its caustic estimate the plain whole
window (``knn``).

* ``radiance_wave`` is the bounce loop: trace, shade, secondary ray,
  shadow rays, direct light, caustic estimate, Russian roulette.  Every
  stochastic stream is keyed on (lane id, purpose, depth), so any subset
  of a frame's lanes gives the same radiance as the whole frame.
* ``Frame`` is the fixed-spp frame: wave w, block-ordered position p of
  the 16x16 pixel blocks has lane id w*N + p, and each wave folds into the
  running mean as the program's ``Renderer._accumulate`` does.
  ``Frame.render_blocks`` renders only the blocks it is given.
* ``precision.lower`` rounds the path state after every bounce in the
  control (``precision.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rng
from .camera import Camera, primary_rays
from .config import RenderConfig
from .geom import normalize, random_unit_vec, PI
from .halton import HaltonSampler, HaltonEnum, MAX_QMC_DIMS
from .knn import sample_photons_plain
from .precision import lower
from .rng import Purpose, hash_u01
from .shading import build_prim_rows, shade_from_rows, secondary_ray
from .trace import trace_closest_rows, trace_any


class PathState(NamedTuple):
    ro: torch.Tensor
    rd: torch.Tensor
    throughput: torch.Tensor
    contrib: torch.Tensor
    radiance: torch.Tensor
    alive: torch.Tensor
    n_closest: torch.Tensor
    n_shadow: torch.Tensor


def _direct_light(scene, cfg: RenderConfig, point, normal, rough, u_light,
                  salt, active=None, ray_id=None):
    """One shadow ray per light per bounce toward a uniform sphere point on
    the light; lights are summed."""
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
        to_l = lpos[None, :] - point
        d = torch.clamp(torch.sum(normal * normalize(to_l), -1), min=0.0)
        # masked-safe pow: d == 0 lanes would give 0^e * log(0) = nan in
        # the roughness gradient
        d_pos = d > 0
        d_safe = torch.where(d_pos, d, 1.0)
        l_term = torch.where(
            d_pos, d_safe ** (1.0 / torch.clamp(rough, min=1e-12)), 0.0)
        hfrac = 1.0 / (PI * torch.sum(to_l * to_l, -1))
        acc = acc + torch.where(occ[:, None], 0.0,
                                lcol[None, :] * (l_term * hfrac)[:, None])
    return acc


def radiance_wave(scene, cfg: RenderConfig, ro, rd, sx_all, sy_all,
                  photon_map=None, lane_ids=None, prim_rows=None,
                  lane_rays=None):
    """Trace a wave through ``cfg.max_depth`` bounces.  Returns ((R,3)
    radiance, (n_closest, n_shadow)): the per-wave counts of alive
    closest-hit lanes and issued shadow-ray lanes, which ``lane_rays``
    (an (R,) int64 tensor) also gets lane by lane.  Lane ids are
    ``lane_ids`` or ``arange(R)``."""
    R = ro.shape[0]
    dev = ro.device
    dt = ro.dtype
    if scene.has_fog:
        raise ValueError("the reference wave has no fog")
    L = scene.lights.count
    rows = prim_rows if prim_rows is not None else build_prim_rows(scene)
    ambient = torch.tensor(cfg.ambient, dtype=dt, device=dev)
    lane = ((lane_ids.to(torch.int64) & 0xFFFFFFFF) if lane_ids is not None
            else torch.arange(R, device=dev) & 0xFFFFFFFF)

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
        valid = st.alive & sh.valid
        if lane_rays is not None:
            lane_rays += st.alive.long() + L * valid.long()
        i_direct = _direct_light(scene, cfg, point, normal, rough, u_light,
                                 salt, active=valid, ray_id=lane)
        if photon_map is not None and depth <= cfg.caustic_max_depth:
            caustic = sample_photons_plain(photon_map, point, out_dir,
                                           cfg.knn_k)
        else:
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


class Frame:
    """The fixed-spp frame of ``width`` x ``height`` pixels: the program's
    ``Renderer`` with ``adaptive=False`` and min = max samples, one
    full-frame wave a sample."""

    def __init__(self, scene, camera: Camera, config: RenderConfig,
                 width: int, height: int, photon_map=None):
        if width % 16 or height % 16:
            raise ValueError("the frame is a whole number of 16x16 blocks")
        self.scene = scene
        self.camera = camera
        self.cfg = config
        self.width, self.height = width, height
        self.device = scene.device
        self.sampler = HaltonSampler()
        self.enum = HaltonEnum(width, height)
        self.photon_map = photon_map
        hi = self.enum.increment * max(config.max_samples, 1)
        self._index_bits = max(int(hi - 1).bit_length(), 1)
        self._key = rng.PRNGKey(config.seed)
        B = 16
        ids = np.arange(height * width).reshape(height, width)
        blocks = [ids[y:y + B, x:x + B].ravel()
                  for y in range(0, height, B) for x in range(0, width, B)]
        self._perm = np.concatenate(blocks)
        self._perm_t = torch.as_tensor(self._perm, device=self.device)
        self._offsets_t = torch.as_tensor(
            self.enum.offsets.astype(np.int64).ravel(), device=self.device)
        self.rows = build_prim_rows(scene)

    @property
    def dtype(self):
        return torch.float64 if self.cfg.dtype == "float64" else torch.float32

    @property
    def n_blocks(self) -> int:
        return (self.width // 16) * (self.height // 16)

    def _bounce_samples(self, idx_flat):
        """(D, R) sample pairs for every bounce: Halton dims 2+2d and 3+2d,
        and past the sampler's 256 dims the threefry streams."""
        sx, sy = [], []
        shape = tuple(idx_flat.shape)
        for d in range(self.cfg.max_depth):
            for dim, purpose, acc in ((2 + 2 * d, Purpose.DEEP_DIM_X, sx),
                                      (3 + 2 * d, Purpose.DEEP_DIM_Y, sy)):
                if dim < MAX_QMC_DIMS:
                    acc.append(self.sampler.sample(dim, idx_flat,
                                                   self._index_bits)
                               .to(self.dtype))
                else:
                    acc.append(rng.uniform(
                        rng.stream(self._key, purpose, d), shape,
                        torch.float64, idx_flat.device).to(self.dtype))
        return torch.stack(sx), torch.stack(sy)

    def wave_inputs(self, wave: int, pos=None):
        """Block-ordered (ro, rd, sx_all, sy_all) of wave ``wave``: the full
        frame, or the block-ordered positions ``pos``."""
        idx = ((self._offsets_t + wave * self.enum.increment)
               & 0xFFFFFFFF)[self._perm_t]
        if pos is not None:
            idx = idx[pos]
        xr = self.sampler.sample(0, idx, self._index_bits).to(self.dtype)
        yr = self.sampler.sample(1, idx, self._index_bits).to(self.dtype)
        ro, rd = primary_rays(self.camera, self.width, self.height,
                              xr * self.enum.scale_x, yr * self.enum.scale_y)
        sx_all, sy_all = self._bounce_samples(idx)
        return ro, rd, sx_all, sy_all

    def block_positions(self, blocks):
        """Block-ordered positions of the 16x16 blocks ``blocks``."""
        return (blocks[:, None] * 256 + torch.arange(
            256, device=self.device)[None, :]).reshape(-1)

    def pixels(self, pos):
        """Raster pixel indices of block-ordered positions ``pos``."""
        return self._perm_t[pos]

    @torch.no_grad()
    def render_blocks(self, blocks):
        """The mean of every wave over the blocks ``blocks`` (block-major
        indices): ((P, 3) radiance of their pixels in ``block_positions``
        order, (P,) closest plus shadow rays of each pixel's lanes)."""
        N = self.width * self.height
        pos = self.block_positions(blocks)
        mean = torch.full((pos.shape[0], 3), 0.5, dtype=self.dtype,
                          device=self.device)
        rays = torch.zeros(pos.shape[0], dtype=torch.int64,
                           device=self.device)
        for s in range(self.cfg.max_samples):
            ro, rd, sx_all, sy_all = self.wave_inputs(s, pos)
            c, n = self.wave_lanes(ro, rd, sx_all, sy_all,
                                   (s * N + pos) & 0xFFFFFFFF)
            # the running mean of Renderer._accumulate (every pixel stays
            # active through min = max samples)
            mean = c if s == 0 else (s * mean + c) / (s + 1.0)
            rays = rays + n
        return mean, rays

    def wave_lanes(self, ro, rd, sx_all, sy_all, lane_ids):
        """One wave of these lanes: ((R, 3) radiance, (R,) closest plus
        shadow rays of each lane)."""
        rays = torch.zeros(ro.shape[0], dtype=torch.int64, device=ro.device)
        c, _ = radiance_wave(self.scene, self.cfg, ro, rd, sx_all, sy_all,
                             self.photon_map, lane_ids, self.rows, rays)
        return c, rays
