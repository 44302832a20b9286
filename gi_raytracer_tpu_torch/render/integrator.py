"""Wavefront path-tracing integrator and the frame ``Renderer``.

Counterpart of ``gi_raytracer_tpu.render.integrator``:

* ``radiance_wave`` is the staged wave: the bounce loop as a Python loop of
  torch stages (trace, shade, secondary ray, shadow rays, direct light,
  caustic estimate, Russian roulette).  It is the render path of scenes
  the megakernel does not take, and on CPU tensors the megakernel's plain
  version.
* ``dispatch_wave`` sends a wave down ``routes.wave``'s route: the
  megakernel (``cuda_megakernel.radiance_wave_mega``, whose caustic query
  records it folds through the kNN estimate) or the staged wave.
* ``Renderer.render`` runs one wave per sample in a Python loop and folds
  each into the accumulation state (running mean, EMA variance, per-pixel
  sample counts).  Rays are traced in 16x16 pixel-block order; wave w,
  block-ordered position p has lane id w*N + p, so every stochastic
  stream matches the JAX renderer's.  Fixed-spp renders trace the full
  frame each wave; adaptive renders trace only the 16x16 blocks that still
  hold an active pixel, all of them as one wave (``Renderer.block_wave``
  either way), and count only the lanes they trace.  The JAX renderer
  groups those blocks into fixed-size dispatches for its static shapes;
  the lane ids, and so the image and the counters, do not depend on the
  grouping.
* A wave's set-up (its Halton dims and primary rays,
  ``Renderer.wave_inputs``) is one launch of the wave-inputs kernel
  (``ops.cuda_wave_inputs``) or its plain version, torch code
  (``Renderer.wave_inputs_plain``).  A frame decides its routes once
  (``Renderer.start``); each ``wave.inputs`` span names its ``route``,
  ``"kernel"`` or ``"torch"``, and each ``wave.trace`` span its wave's,
  ``"k1"`` or ``"staged"``.
* On the card a staged wave of the band's full lane count is one CUDA
  graph's replay (``WaveGraph``, ``Renderer.replay_wave``) where the
  frame's ``routes.wave_graph`` allows it: the graph is captured once a
  renderer (again after a change to its scene or config) and every such
  wave copies its inputs in and replays it.  The wave therefore waits for
  nothing on the host: the hash's integer keys are folded there
  (``rng.hash_bits``) and the ambient tensor is made once a renderer
  (``Renderer.ambient``).  Each ``wave.trace`` span names its ``graph``,
  ``"replay"`` or ``"eager"``.
* In a fog scene every bounce marches the fog after the closest hit
  (``atmosphere.fog_override``) and every shadow ray through it
  (``atmosphere.fog_occludes``).
* Bounce dims past Halton's 256 (depth > 127) draw from the threefry
  streams ``stream(key, DEEP_DIM_X | DEEP_DIM_Y, depth)`` of the JAX
  renderer, at JAX's default float width in the configuration its tests
  pin (``jax_enable_x64``: float64), cast to the render's dtype.
* ``Renderer(rows=(y0, y1))`` renders one band of the frame (a multiple
  of 16 rows; the ranks of ``parallel.mesh.render_fused_sharded``): its
  lanes keep the frame's lane ids, so a band's pixels equal the same
  pixels of the whole frame's render.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import routes, telemetry
from ..config import RenderConfig
from ..ops import _cuda, cuda_wave_inputs
from ..ops.cuda_megakernel import FAR, radiance_wave_mega
from ..ops.intersect import trace_closest_rows, trace_any
from ..ops.prim_rows import build_prim_rows
from ..sampling.halton import HaltonSampler, HaltonEnum, MAX_QMC_DIMS
from ..sampling import rng
from ..sampling.rng import Purpose, hash_u01
from ..scene.types import dataclass_tensors, derived
from . import photon
from .atmosphere import fog_occludes, fog_override
from .camera import Camera, primary_rays, ray_frame
from .geom import normalize, random_unit_vec, PI
from .shading import shade_from_rows, secondary_ray


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
                  salt, active=None, ray_id=None, plain=False):
    """One shadow ray per light per bounce toward a uniform sphere point on
    the light; lights are summed.  In fog a shadow ray is also occluded
    where the march scatters before the light (marched on ``active`` lanes
    only: the others' light is never used)."""
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
                        active=active, ray_id=ray_id, plain=plain)
        if scene.has_fog:
            occ = occ | fog_occludes(
                scene, cfg, so, normalize(ldir), t_lim,
                (salt + 104729 * (li + 1)) & 0xFFFFFFFF, ray_id=ray_id,
                active=active)
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


def ambient_tensor(cfg: RenderConfig, dtype, device) -> torch.Tensor:
    """``cfg.ambient`` as a (3,) tensor on ``device`` (a copy to the card,
    which waits)."""
    with telemetry.sync("wave.ambient"):
        return torch.tensor(cfg.ambient, dtype=dtype, device=device)


def radiance_wave(scene, cfg: RenderConfig, ro, rd, sx_all, sy_all,
                  wave_salt=0, photon_map=None, lane_base=0, lane_ids=None,
                  prim_rows=None, plain=False, ambient=None):
    """Trace a wave through ``cfg.max_depth`` bounces.  Returns ((R,3)
    radiance, (n_closest, n_shadow)): the honest per-wave counts of alive
    closest-hit lanes and issued shadow-ray lanes.

    Every stochastic stream is keyed on (lane id, purpose, depth); lane ids
    are ``lane_ids`` or ``lane_base + arange(R)``.  ``plain=True`` runs the
    plain trace and kNN versions on any device (comparison runs only,
    counted as K1's plain version).  ``ambient``: ``cfg.ambient`` as a
    tensor of the rays' dtype and device (``ambient_tensor``, made here
    when None)."""
    if plain:
        _cuda.plain_calls["megakernel"] += 1
    R = ro.shape[0]
    dev = ro.device
    dt = ro.dtype
    L = scene.lights.count
    rows = prim_rows if prim_rows is not None else build_prim_rows(scene)
    if ambient is None:
        ambient = ambient_tensor(cfg, dt, dev)
    lane = ((lane_ids.to(torch.int64) & 0xFFFFFFFF) if lane_ids is not None
            else (int(lane_base) + torch.arange(R, device=dev)) & 0xFFFFFFFF)

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
        salt = (int(wave_salt) + depth * 31337) & 0xFFFFFFFF
        u_rr = u(Purpose.RUSSIAN_ROULETTE, salt)
        u_op = u(Purpose.RAY_TYPE_OPACITY, salt)
        u_fs = u(Purpose.RAY_TYPE_FRESNEL, salt)
        u_light = [u(int(Purpose.LIGHT_POINT_X) + 16 * li + axis, salt)
                   for li in range(L) for axis in range(2)]

        hit, row = trace_closest_rows(scene, rows, st.ro, st.rd, salt=salt,
                                      eps=cfg.epsilon, active=st.alive,
                                      ray_id=lane, plain=plain)
        sh = shade_from_rows(scene, row, st.ro, st.rd, hit.t, hit.prim,
                             hit.u, hit.v)
        sec = secondary_ray(st.rd, sh.normal, sh.color, sh.alpha, sh.rough,
                            sh.ior, sx_all[depth], sy_all[depth], u_op, u_fs,
                            st.contrib)
        point, normal, out_dir, f, color, contrib, rough, offset_sign = (
            sh.point, sec.normal, sec.dir, sec.f, sh.color, sec.contrib,
            sh.rough, sec.offset_sign)
        if scene.has_fog:
            (point, normal, out_dir, f, color, contrib, rough,
             offset_sign) = fog_override(
                scene, cfg, st.ro, st.rd, hit.t, sx_all[depth],
                sy_all[depth], salt, point, normal, out_dir, f, color,
                contrib, rough, offset_sign, ray_id=lane, active=st.alive)
        valid = st.alive & sh.valid
        i_direct = _direct_light(scene, cfg, point, normal, rough, u_light,
                                 salt, active=valid, ray_id=lane, plain=plain)
        if photon_map is not None and depth <= cfg.caustic_max_depth:
            caustic = photon.sample_photons_backend(
                photon_map, point, out_dir, cfg.knn_k, cfg.knn_backend,
                plain=plain)
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
            point + (offset_sign * cfg.shadow_bias)[:, None] * normal,
            out_dir, st.throughput * f * boost[:, None], contrib, lum,
            valid & survive, st.n_closest + st.alive.sum(),
            st.n_shadow + L * valid.sum())
    return st.radiance, (st.n_closest, st.n_shadow)


def dispatch_wave(scene, cfg, ro, rd, sx_all, sy_all, wave_salt=0,
                  photon_map=None, lane_base=0, lane_ids=None,
                  prim_rows=None, route=None, ambient=None):
    """Render-path wave down ``route`` (``routes.wave``'s, decided anew when
    None): the megakernel or the staged ``radiance_wave``, handed
    ``ambient``.  On K1's route a wave whose inputs carry a gradient is
    refused on either device (K1 is forward-only), and CPU tensors take
    the staged wave, K1's plain version, on the same lanes.  Returns (radiance (R,3), (n_closest,
    n_shadow))."""
    route = route or routes.wave(scene, cfg)[0]
    if route == "staged" and cfg.integrator == "mega":
        raise ValueError("integrator='mega' requested but the scene is not "
                         "megakernel-eligible: "
                         + "; ".join(routes.wave(scene, cfg)[1]))
    why = routes.k1_refusal(scene, ro, rd, photon_map) if route == "k1" else []
    if why:
        raise ValueError("the megakernel is forward-only: " + "; ".join(why)
                         + "; gradient paths call the staged radiance_wave "
                         "(Renderer._wave)")
    if route == "staged" or ro.device.type == "cpu":
        if route == "k1":       # the staged wave as K1's plain version
            _cuda.plain_calls["megakernel"] += 1
        return radiance_wave(scene, cfg, ro, rd, sx_all, sy_all, wave_salt,
                             photon_map, lane_base=lane_base,
                             lane_ids=lane_ids, prim_rows=prim_rows,
                             ambient=ambient)
    lane = (lane_ids if lane_ids is not None
            else (int(lane_base) + torch.arange(ro.shape[0], device=ro.device))
            & 0xFFFFFFFF)
    rec = (None if photon_map is None else torch.empty(
        (ro.shape[0], int(cfg.max_depth), 9), dtype=torch.float32,
        device=ro.device))
    radiance, counts = radiance_wave_mega(scene, cfg, ro, rd, sx_all, sy_all,
                                          lane, wave_salt, rec)
    if rec is not None:
        radiance = radiance + _caustic_fold(photon_map, cfg, rec)
    return radiance.to(ro.dtype), counts


def _caustic_fold(photon_map, cfg, rec):
    """K1's (R, 3) caustic term from its (R, D, 9) query records (point,
    direction, weight a bounce): the kNN estimate (looked up on ``photon``
    at each call) at the live records, weighted and summed over bounces."""
    R, D = rec.shape[:2]
    pts = rec[:, :, 0:3].reshape(R * D, 3)
    dirs = rec[:, :, 3:6].reshape(R * D, 3)
    wts = rec[:, :, 6:9].reshape(R * D, 3)
    with telemetry.sync("mega.live"):
        live = torch.nonzero((pts[:, 0] < FAR)
                             & (wts.max(dim=-1).values > 0)).squeeze(1)
    est = torch.zeros_like(pts)
    if live.numel():
        est[live] = photon.sample_photons_backend(
            photon_map, pts[live], dirs[live], cfg.knn_k, cfg.knn_backend)
    return (wts * est).reshape(R, D, 3).sum(1)


class WaveGraph:
    """The staged ``radiance_wave`` over a band's full lane count as one
    CUDA graph (``routes.wave_graph``'s ``"replay"``).  The capture records
    the wave's operations and runs none of them.  Each call copies that
    wave's inputs (rays, bounce samples, lane ids) into the graph's static
    buffers, replays it and copies the radiance and the two counters out:
    the graph holds no result across waves.  ``wave``, the function
    captured, is kept with the tensors its closure holds, which every
    replay reads by address."""

    def __init__(self, wave, ro, rd, sx_all, sy_all, lane):
        self.wave = wave
        self.inputs = [t.clone() for t in (ro, rd, sx_all, sy_all, lane)]
        self.graph = torch.cuda.CUDAGraph()
        before = _cuda.launches.copy()
        # the capture synchronises the card before it starts
        with telemetry.sync("wave.graph"), telemetry.muted(), \
                torch.cuda.graph(self.graph):
            self.out = wave(*self.inputs)
        # the wrappers counted the launches the capture recorded: each
        # replay makes them
        self.launches = _cuda.launches - before
        _cuda.launches.subtract(self.launches)

    def __call__(self, ro, rd, sx_all, sy_all, lane):
        for dst, src in zip(self.inputs, (ro, rd, sx_all, sy_all, lane)):
            dst.copy_(src)
        self.graph.replay()
        _cuda.launches.update(self.launches)
        radiance, (n_c, n_s) = self.out
        return radiance.clone(), (n_c.clone(), n_s.clone())


class FrameRoutes(NamedTuple):
    """What a frame decides once (``Renderer.start``)."""
    wave: str                   # routes.wave's route
    inputs: str                 # routes.wave_inputs's
    cam: torch.Tensor | None    # the camera's constants on the kernel route
    graph: str                  # routes.wave_graph's, for full-band waves


class Renderer:
    """Frame renderer: one QMC wave per sample, the full frame or (adaptive
    renders) the 16x16 blocks still active.  ``block_compaction=False``
    traces the full frame on adaptive renders too (the same image, samples
    and active masks; more rays), for comparisons.

    ``rows=(y0, y1)`` renders rows [y0, y1) of the width x height frame:
    images and states are (y1 - y0, width), and lane ids, samples and
    blocks are the frame's (y0 and y1 - y0 multiples of 16, or the band
    the whole frame)."""

    def __init__(self, scene, camera: Camera, config: RenderConfig,
                 width: int, height: int, photon_map=None,
                 block_compaction: bool = True, rows=None):
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
        y0, y1 = rows if rows is not None else (0, height)
        if (y0, y1) != (0, height) and (y0 % B or (y1 - y0) % B
                                        or not 0 <= y0 < y1 <= height):
            raise ValueError(f"rows {(y0, y1)} of {height}: a band of "
                             f"16-row blocks")
        self.rows = (y0, y1)
        self.band_height = y1 - y0
        # the band's first lane: the frame's blocks above it hold y0*W
        # lanes in block order
        self._lane0 = y0 * width
        # 16x16 pixel-block ray order: block-ordered position p traces
        # band raster pixel perm[p]
        Hb = self.band_height
        ids = np.arange(Hb * width).reshape(Hb, width)
        blocks = [ids[y:y + B, x:x + B].ravel()
                  for y in range(0, Hb, B) for x in range(0, width, B)]
        self._perm = np.concatenate(blocks)
        self._inv_perm = np.argsort(self._perm).astype(np.int64)
        self._perm_t = torch.as_tensor(self._perm, device=self.device)
        self._inv_perm_t = torch.as_tensor(self._inv_perm, device=self.device)
        self._offsets_t = torch.as_tensor(
            self.enum.offsets[y0:y1].astype(np.int64).ravel(),
            device=self.device)
        self.block_compaction = block_compaction
        self.block_adaptive = (block_compaction and config.adaptive
                               and config.max_samples > config.min_samples
                               and Hb % B == 0 and width % B == 0)
        # blocks traced by each wave of the last render (block-adaptive)
        self.wave_blocks: list = []
        # the frame's routes (``start``), the wave-inputs kernel's launch
        # with the sampler and depth it was made for, and the full band's
        # wave graph (``replay_wave``, kept by ``derived``)
        self._frame = None
        self._inputs_launch = None
        self._graph = None

    @property
    def dtype(self):
        return torch.float64 if self.cfg.dtype == "float64" else torch.float32

    def prim_rows(self):
        """The packed shade-row table of the renderer's scene, kept on the
        renderer and built again after the scene's tensors change."""
        return derived(self, "_prim_rows", self.scene.table_sources(),
                       lambda: build_prim_rows(self.scene))

    def ambient(self):
        """``cfg.ambient`` as a tensor of the renderer's dtype and device,
        kept on the renderer: the staged waves' (eager and replayed)."""
        return derived(self, "_ambient", [self.cfg],
                       lambda: ambient_tensor(self.cfg, self.dtype,
                                              self.device))

    def _bounce_samples(self, idx_flat):
        """(D, R) sample pairs for every bounce: Halton dims 2+2d and 3+2d,
        and past the sampler's 256 dims the JAX renderer's threefry
        streams (float64 draws of the whole lane count, as
        ``jax.random.uniform(key, idx.shape)`` under x64)."""
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

    def frame_routes(self) -> FrameRoutes:
        """The routes of a frame's waves, decided now, and on the kernel
        route the (14,) camera constants of its rays: position, up, right,
        screen centre, half-width and half-height, by ``primary_rays``' own
        arithmetic (``camera.ray_frame``)."""
        inputs = routes.wave_inputs(self.cfg, self.device, self.sampler,
                                    self.camera)[0]
        cam = None
        if inputs == "kernel":
            *c, shw, shh = ray_frame(self.camera, self.width, self.height,
                                     self.dtype, self.device)
            cam = torch.cat(c + [shw.reshape(1), shh.reshape(1)])
        wave = routes.wave(self.scene, self.cfg)[0]
        pm = self.photon_map
        graph = routes.wave_graph(
            self.scene, wave, pm, self.device,
            (self.scene.table_sources(), dataclass_tensors(self.scene.lights),
             self.camera.pos, self.camera.look_at,
             () if pm is None else (pm.pos, pm.dir, pm.col)))[0]
        return FrameRoutes(wave, inputs, cam, graph)

    def halton_index(self, wave: int, pos=None):
        """The Halton indices of wave ``wave``'s lanes in block order, or at
        the block-ordered positions ``pos``."""
        idx = ((self._offsets_t + wave * self.enum.increment)
               & 0xFFFFFFFF)[self._perm_t]
        return idx if pos is None else idx[pos]

    def wave_inputs(self, wave: int, pos=None, frame=None):
        """Block-ordered (ro, rd, sx_all, sy_all) of wave ``wave``: the full
        band, or the block-ordered positions ``pos``; down ``frame``'s
        set-up route (``frame_routes``, decided anew when None)."""
        frame = self.frame_routes() if frame is None else frame
        if frame.inputs == "torch":
            return self.wave_inputs_plain(self.halton_index(wave, pos))
        depth = self.cfg.max_depth
        kept = self._inputs_launch
        if kept is None or kept[0] != (self.sampler, depth):
            kept = ((self.sampler, depth), cuda_wave_inputs.wave_launcher(
                self.sampler, self._offsets_t, self._perm_t, depth,
                self._index_bits, self.enum.scale_x, self.enum.scale_y,
                self.width, self.height))
            self._inputs_launch = kept
        return kept[1](wave * self.enum.increment, pos, frame.cam)

    def wave_inputs_plain(self, idx):
        """(ro, rd, sx_all, sy_all) of the lanes of Halton indices ``idx``
        in torch on any device: the wave-inputs kernel's plain version and
        the gradient entry's set-up."""
        xr = self.sampler.sample(0, idx, self._index_bits).to(self.dtype)
        yr = self.sampler.sample(1, idx, self._index_bits).to(self.dtype)
        ro, rd = primary_rays(self.camera, self.width, self.height,
                              xr * self.enum.scale_x, yr * self.enum.scale_y)
        sx_all, sy_all = self._bounce_samples(idx)
        return ro, rd, sx_all, sy_all

    def _wave(self, scene, photon_map, idx_flat, wave_i: int):
        """The gradient entry: one full-frame wave of ``scene`` (any Scene
        of the renderer's camera and size, its tensors possibly carrying
        gradients) -> (H*W, 3) radiance in raster order.  ``idx_flat`` is
        the raster-order per-pixel Halton indices (``enum.index_image``).
        Gradients always take the staged ``radiance_wave`` (the
        megakernel is forward-only), and its shade rows are built from
        ``scene`` itself, never from the renderer's own table."""
        N = self.width * self.height
        idx = torch.as_tensor(idx_flat, device=self.device)[self._perm_t]
        out, _ = radiance_wave(scene, self.cfg, *self.wave_inputs_plain(idx),
                               0, photon_map, lane_base=int(wave_i) * N,
                               prim_rows=build_prim_rows(scene))
        return out[self._inv_perm_t]

    def replay_wave(self, ro, rd, sx_all, sy_all, lane):
        """The full band's staged wave by the renderer's CUDA graph
        (``WaveGraph``), kept while the scene's tables and lights, the
        prim-row table and the config are the same; else the wave runs
        eagerly, which builds what the capture reads, and the graph is
        captured after it.  ``lane``: the lane ids."""
        scene, cfg, rows, amb = (self.scene, self.cfg, self.prim_rows(),
                                 self.ambient())

        def wave(ro, rd, sx_all, sy_all, lane):
            return radiance_wave(scene, cfg, ro, rd, sx_all, sy_all, 0,
                                 lane_ids=lane, prim_rows=rows, ambient=amb)

        eager = []

        def capture():
            eager.append(wave(ro, rd, sx_all, sy_all, lane))
            return WaveGraph(wave, ro, rd, sx_all, sy_all, lane)

        g = derived(self, "_graph",
                    [scene, cfg, rows, amb, *scene.table_sources(),
                     *dataclass_tensors(scene.lights)], capture)
        return eager[0] if eager else g(ro, rd, sx_all, sy_all, lane)

    def active_blocks(self, active):
        """Block-major indices (in the band) of the 16x16 blocks of
        ``active`` (Hb, W) that hold an active pixel."""
        H, W = self.band_height, self.width
        act = active.reshape(H // 16, 16, W // 16, 16).any(3).any(1)
        with telemetry.sync("wave.blocks"):
            return torch.nonzero(act.reshape(-1)).squeeze(1)

    def block_wave(self, wave: int, blocks=None, frame=None):
        """One wave of the band -> ((Hb, W, 3) raster radiance, ray count):
        every lane, or (``blocks``, block-major indices) the lanes of those
        16x16 blocks as one dispatch, the image zero outside them.  Block
        b's lane j has lane id wave*N + lane0 + b*256 + j, as in the full
        frame.  ``frame``: the frame's routes (``frame_routes``, decided
        anew when None).  A wave of the full band's lanes replays the
        renderer's CUDA graph where the frame's ``graph`` allows it
        (``replay_wave``); the ``wave.trace`` span names which in its
        ``graph``."""
        frame = self.frame_routes() if frame is None else frame
        H, W = self.band_height, self.width
        base = wave * W * self.height + self._lane0
        pos = None
        with telemetry.span("wave.inputs", route=frame.inputs):
            if blocks is not None:
                pos = (blocks[:, None] * 256
                       + torch.arange(256, device=self.device)[None, :]
                       ).reshape(-1)
                c = torch.zeros((H * W, 3), dtype=self.dtype,
                                device=self.device)
                if pos.numel() == 0:        # a quiet band traces nothing
                    return (c.reshape(H, W, 3),
                            torch.zeros((), dtype=torch.int64,
                                        device=self.device))
            ro, rd, sx_all, sy_all = self.wave_inputs(wave, pos, frame)
        graph = frame.graph if ro.shape[0] == H * W else "eager"
        with telemetry.span("wave.trace", route=frame.wave,
                            graph=graph):
            if graph == "replay":
                lane = (base + (torch.arange(H * W, device=self.device)
                                if pos is None else pos)) & 0xFFFFFFFF
                out, (n_c, n_s) = self.replay_wave(ro, rd, sx_all, sy_all,
                                                   lane)
            else:
                lanes = ({"lane_base": base} if pos is None
                         else {"lane_ids": (base + pos) & 0xFFFFFFFF})
                out, (n_c, n_s) = dispatch_wave(
                    self.scene, self.cfg, ro, rd, sx_all, sy_all, 0,
                    self.photon_map, prim_rows=self.prim_rows(),
                    route=frame.wave, ambient=self.ambient(), **lanes)
            if pos is not None:
                c[pos] = out.to(c.dtype)
                out = c
            return out[self._inv_perm_t].reshape(H, W, 3), n_c + n_s

    def state0(self):
        """Fresh accumulation state (running mean starts at 0.5)."""
        H, W = self.band_height, self.width
        dev = self.device
        return {
            "mean": torch.full((H, W, 3), 0.5, dtype=self.dtype, device=dev),
            "var": torch.zeros((H, W), dtype=self.dtype, device=dev),
            "samps": torch.zeros((H, W), dtype=torch.int32, device=dev),
            "active": torch.ones((H, W), dtype=torch.bool, device=dev),
            "wave": 0,
            "rays": torch.zeros((), dtype=torch.int64, device=dev),
        }

    def _accumulate(self, st, c, s: int):
        """One adaptive-sampling update (EMA variance, sample counts)."""
        cfg = self.cfg
        mean, var = st["mean"], st["var"]
        samps, active = st["samps"], st["active"]
        new_mean = c if s == 0 else (s * mean + c) / (s + 1.0)
        mean_out = torch.where(active[..., None], new_mean, mean)
        dv = torch.linalg.vector_norm(new_mean - mean, dim=-1)
        var = torch.where((s > 0) & active, (5.0 * var + dv) / 6.0, var)
        extend = (s > 0) & (var > cfg.noise_thresh)
        samps = torch.where(active, samps + 1 - 2 * extend.to(torch.int32),
                            samps)
        active = active & (samps < cfg.min_samples)
        return {"mean": mean_out, "var": var, "samps": samps,
                "active": active, "wave": s + 1, "rays": st["rays"]}

    @torch.no_grad()
    def render(self, verbose: bool = False, on_wave=None, state=None,
               return_state: bool = False):
        """Multi-wave render -> linear (H, W, 3) mean image.

        ``on_wave(state, wave)`` is called after every wave with the whole
        accumulation state, which can be saved and passed back as
        ``state=`` to resume the render (the checkpoint hook)."""
        with telemetry.span("frame"):
            st = self.start(state)
            for s in range(int(st["wave"]), self.cfg.max_samples):
                with telemetry.sync("frame.active"):
                    go = bool(st["active"].any())
                if not go:
                    break
                st = self.step(st, s)
                if verbose:
                    with telemetry.sync("frame.verbose"):
                        print(f"wave {s}: active {int(st['active'].sum())}/"
                              f"{st['active'].numel()}")
                if on_wave is not None:
                    on_wave(st, s)
        return (st["mean"], st) if return_state else st["mean"]

    def start(self, state=None):
        """The state a render starts from (``state0`` or ``state``, with an
        int64 ray counter: an older checkpoint's float32 one is cast, a
        missing one starts at 0), and an empty ``wave_blocks`` record; it
        decides the frame's routes (``frame_routes``), which ``step``
        reads."""
        st = state if state is not None else self.state0()
        rays = st.get("rays")
        if rays is None:
            rays = torch.zeros((), dtype=torch.int64, device=self.device)
        elif rays.dtype != torch.int64:
            rays = rays.to(torch.int64)
        self.wave_blocks = []
        self._frame = self.frame_routes()
        return dict(st, rays=rays)

    def step(self, st, s: int, reduce_rays=None):
        """Wave ``s`` of a render: trace the band (or its active blocks)
        and fold it into the state.  ``reduce_rays(n)`` turns the wave's
        ray count into the one added to the counter (the ranks' sum, in a
        sharded render); the routes are ``start``'s, or decided anew
        before it."""
        frame = self.frame_routes() if self._frame is None else self._frame
        with telemetry.span("wave", wave=s) as sp:
            blocks = None
            if self.block_adaptive:
                with telemetry.span("wave.inputs", route=frame.inputs):
                    blocks = self.active_blocks(st["active"])
            c, rays = self.block_wave(s, blocks, frame)
            if blocks is not None:
                n_blocks = blocks.numel()
                self.wave_blocks.append(n_blocks)
                lanes = 256 * n_blocks
            else:
                n_blocks = -(-self.band_height // 16) * -(-self.width // 16)
                lanes = self.band_height * self.width
            if sp is not None:
                sp.attrs.update(blocks=n_blocks, lanes=lanes)
            with telemetry.span("wave.fold"):
                if reduce_rays is not None:
                    rays = reduce_rays(rays)
                st = self._accumulate(st, c, s)
                st["rays"] = st["rays"] + rays
        return st

    def tonemap(self, linear):
        """Gamma + clamp."""
        g = torch.pow(torch.clamp(linear, min=0.0), 1.0 / self.cfg.gamma)
        return torch.clamp(g, 0.0, 1.0)


def render_image(scene, camera: Camera, config: RenderConfig, width: int,
                 height: int, photon_map=None, verbose: bool = False):
    """A whole render, tonemapped: (H, W, 3) in [0, 1]."""
    r = Renderer(scene, camera, config, width, height, photon_map)
    return r.tonemap(r.render(verbose=verbose))
