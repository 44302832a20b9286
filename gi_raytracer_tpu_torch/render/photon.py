"""Photon-mapped caustics: emission wavefront, uniform-grid map, kNN
estimate (counterpart of ``gi_raytracer_tpu.render.photon``).

* Emission is a wavefront: every slot emits at once; a slot's retries are
  masked re-emission rounds (at most ``cfg.photon_retries``) that stop as
  soon as every slot stored (all of them with ``differentiable=True``);
  the specular continuation chain runs ``cfg.photon_depth`` closest-hit
  traces.
* ``PhotonMap.rebind`` puts a re-traced batch on a map's frozen structure:
  the gradient path through the caustic estimate.
* The map is a uniform grid fitted to the stored photons, refined until the
  densest cell holds at most ``window_cap_max`` photons; photons are sorted
  by cell with a stable argsort and ``cell_start`` holds the cell ranges.
* The estimate is ``photon_knn.sample_photons_tiled``, the whole-window
  estimate of the TPU kNN kernels (the kNN kernel on the card);
  ``sample_photons`` is the JAX package's capped per-point estimator,
  which ``knn_backend="jnp"`` names (``sample_photons_backend``).

A retry round runs one of two ways, chosen per pass by
``routes.photon_round``: where the kernel takes the pass, as one launch of
the walk kernel's photon-round policy (``ops.cuda_photon.round_launcher``),
which updates the chunk in place; everywhere else as the staged round
(``_emit_attempts``): torch operations around six K2 trace calls, the plain
version the kernel is held to.  Each ``photons.round`` span names its
``route``: ``"k2"`` or ``"staged"``.

Emission draws its direction and BSDF uniforms from a ``uniform(li, chunk,
round, depth, shape, dtype)`` source.  The default,
``sampling.rng.ThreefryUniform``, draws the JAX package's threefry
streams along its key path, so the port's photon batch equals the JAX
package's slot for slot; the tests may pass another source (one that
replays JAX's own draws).

``trace_photons_sharded`` splits the slots over the ranks of a process
group: rank r emits slots [r*per, (r+1)*per) as chunk r, and the batches
are all-gathered, so every rank holds the batch ``trace_photons`` gives
with ``ray_chunk = per``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import routes, telemetry
from ..config import RenderConfig
from ..ops import cuda_photon
from ..ops.intersect import trace_closest
from ..sampling.halton import HaltonSampler
from ..sampling.rng import ThreefryUniform
from .geom import normalize, random_unit_vec, sphere_cap_cos
from .photon_knn import sample_photons_capped as sample_photons
from .photon_knn import sample_photons_plain, sample_photons_tiled
from .shading import hit_attributes_uv, material_lookup, secondary_ray


@dataclasses.dataclass
class PhotonMap:
    pos: torch.Tensor          # (P,3) cell-sorted
    dir: torch.Tensor          # (P,3)
    col: torch.Tensor          # (P,3)
    valid: torch.Tensor        # (P,) bool
    cell_start: torch.Tensor   # (C+1,) int32 prefix ranges into the arrays
    grid_min: torch.Tensor     # (3,)
    inv_cell: torch.Tensor     # (3,) 1 / cell size
    order: torch.Tensor = None  # (P,) int32 batch -> sorted permutation
    dims: tuple = (1, 1, 1)
    window_cap: int = 8

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    def rebind(self, batch: "PhotonBatch") -> "PhotonMap":
        """Re-attach a (differentiably re-traced) PhotonBatch to this map's
        frozen structure (cells, sort order, window cap): the
        detached-structure estimator, whose photon positions, directions
        and colours carry gradients back to light and material
        parameters."""
        o = self.order.long()
        return dataclasses.replace(self, pos=batch.pos[o], dir=batch.dir[o],
                                   col=batch.col[o], valid=batch.stored[o])


class PhotonBatch(NamedTuple):
    pos: torch.Tensor
    dir: torch.Tensor
    col: torch.Tensor
    stored: torch.Tensor


def _round_salt(li: int, rnd: int) -> int:
    """The alpha-stream salt of round ``rnd``'s emission trace; chain step
    d adds (d + 1) * 7919."""
    return ((li + 1) * 40503 + rnd * 2654435761) & 0xFFFFFFFF


def _emit_attempts(scene, cfg: RenderConfig, sampler: HaltonSampler, li: int,
                   h_idx, uniform, chunk: int, rnd: int, active,
                   slot_ids, total_count) -> PhotonBatch:
    """One emission round for light ``li``, one lane per slot; ``active``
    marks the slots still retrying.  Depth -1 of ``uniform`` is the
    emission direction, depth d >= 0 the chain's BSDF uniforms."""
    R = h_idx.shape[0]
    lt = scene.lights
    dt = lt.pos.dtype
    lpos, lcol, lrad = lt.pos[li], lt.col[li], lt.rad[li]
    ldir, langle = lt.dir[li], lt.angle[li]

    sx = sampler.sample(0, h_idx).to(dt)
    sy = sampler.sample(1, h_idx).to(dt)
    cap = sphere_cap_cos(torch.broadcast_to(ldir, (R, 3)), sx, sy, 1.0, langle)
    surf = torch.where(langle < 1.0, cap, random_unit_vec(sx, sy))
    pos = lpos[None, :] + lrad * surf

    u = uniform(li, chunk, rnd, -1, (2, R), dt)
    emit_dir = sphere_cap_cos(normalize(pos - lpos[None, :]), u[0], u[1],
                              2.0, langle)
    col = torch.broadcast_to((0.5 * langle / total_count) * lcol,
                             (R, 3)).to(dt)

    salt0 = _round_salt(li, rnd)
    hit = trace_closest(scene, pos, emit_dir, salt=salt0, eps=cfg.epsilon,
                        active=active, ray_id=slot_ids)
    attrs = hit_attributes_uv(scene, pos, emit_dir, hit.t, hit.prim,
                              hit.u, hit.v)
    rough = material_lookup(scene, attrs.mat_id, attrs.uv)[3]
    alive = active & attrs.valid & (rough < 0.1)     # specular-first only

    ro, rd = pos, emit_dir
    stored = torch.zeros(R, dtype=torch.bool, device=pos.device)
    p_pos = torch.zeros((R, 3), dtype=dt, device=pos.device)
    p_dir = torch.zeros_like(p_pos)
    p_col = torch.zeros_like(p_pos)
    ones = torch.ones((R, 3), dtype=dt, device=pos.device)
    for depth in range(cfg.photon_depth):
        salt = (salt0 + (depth + 1) * 7919) & 0xFFFFFFFF
        uni = uniform(li, chunk, rnd, depth, (4, R), dt)
        hit = trace_closest(scene, ro, rd, salt=salt, eps=cfg.epsilon,
                            active=alive, ray_id=slot_ids)
        attrs = hit_attributes_uv(scene, ro, rd, hit.t, hit.prim, hit.u, hit.v)
        color, _, alpha, rough, ior = material_lookup(scene, attrs.mat_id,
                                                      attrs.uv)
        sec = secondary_ray(rd, attrs.normal, color, alpha, rough, ior,
                            uni[0], uni[1], uni[2], uni[3], ones)
        live = alive & attrs.valid
        col = torch.where(live[:, None], col * sec.f, col)
        new_ro = attrs.point + (sec.offset_sign * cfg.shadow_bias)[:, None] \
            * sec.normal
        # the first diffuse hit after the specular chain stores the photon
        store_now = live & (rough >= 0.1) & ~stored
        ro = torch.where(live[:, None], new_ro, ro)
        rd = torch.where(live[:, None], sec.dir, rd)
        alive = live & (rough < 0.1)
        stored = stored | store_now
        p_pos = torch.where(store_now[:, None], attrs.point, p_pos)
        p_dir = torch.where(store_now[:, None], sec.dir, p_dir)
        p_col = torch.where(store_now[:, None], col, p_col)
    return PhotonBatch(p_pos, p_dir, p_col, stored)


def _emit_chunk(scene, cfg, sampler, uniform, chunk: int, start: int, li: int,
                n_slots: int, total_count: int,
                differentiable: bool = False, light=None) -> PhotonBatch:
    """First-success emission for slots [start, start+n_slots) of light
    ``li``: masked retry rounds until every slot stored or
    ``cfg.photon_retries`` rounds ran (``differentiable``: every round,
    with no early exit, as the JAX package's ``lax.scan``).  Each round
    traces every slot of the chunk (its span's ``lanes``); ``live``, the
    slots still unstored at its start, comes from the count that decides
    the early exit (not taken when ``differentiable``).  With ``light``,
    the light's constants (``_light_row``), each round is one launch of
    the round kernel, which merges into the chunk in place and keeps its
    stored count on the card; without, the staged round."""
    retries = max(cfg.photon_retries, 1)
    dev = scene.device
    dt = scene.lights.pos.dtype
    pos = torch.zeros((n_slots, 3), dtype=dt, device=dev)
    dirs = torch.zeros_like(pos)
    col = torch.zeros_like(pos)
    stored = torch.zeros(n_slots, dtype=torch.bool, device=dev)
    if light is None:
        route = "staged"
        slot = start + torch.arange(n_slots, dtype=torch.int64, device=dev)
    else:
        route = "k2"
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        launch = cuda_photon.round_launcher(
            scene, light, uniform.round_keys(li, chunk, retries,
                                             cfg.photon_depth),
            pos, dirs, col, stored, count, start, cfg.epsilon,
            cfg.shadow_bias, sampler.arith_plan(3))    # Halton dim 1
    for rnd in range(retries):
        live = {}
        if not differentiable:
            # the count costs a kernel more than a test of all() (the sum
            # casts the mask first); a round negates the mask once, not
            # twice, so it issues as many operations as before
            with telemetry.sync("photons.live"):
                n_stored = int(stored.sum() if light is None else count)
            if n_stored == n_slots:
                break
            live = {"live": n_slots - n_stored}
        with telemetry.span("photons.round", round=rnd, lanes=n_slots,
                            route=route, **live):
            if light is not None:
                launch(rnd, _round_salt(li, rnd))
                continue
            h_idx = (slot * retries + rnd) & 0xFFFFFFFF
            unstored = ~stored
            wave = _emit_attempts(scene, cfg, sampler, li, h_idx, uniform,
                                  chunk, rnd, unstored, slot, total_count)
            new = wave.stored & unstored
            pos = torch.where(new[:, None], wave.pos, pos)
            dirs = torch.where(new[:, None], wave.dir, dirs)
            col = torch.where(new[:, None], wave.col, col)
            stored = stored | new
    return PhotonBatch(pos, dirs, col, stored)


def _light_row(scene, li: int, total_count: int) -> torch.Tensor:
    """The round kernel's 11 constants of light ``li``: position, cone
    axis, radius, cone fraction and each slot's emitted colour, computed
    as ``_emit_attempts`` computes them."""
    lt = scene.lights
    langle = lt.angle[li]
    return torch.cat([lt.pos[li], lt.dir[li], lt.rad[li:li + 1],
                      lt.angle[li:li + 1],
                      (0.5 * langle / total_count) * lt.col[li]]).contiguous()


def trace_photons(scene, cfg: RenderConfig, sampler=None, count=None,
                  uniform=None, differentiable: bool = False) -> PhotonBatch:
    """Emit ``count`` (default ``cfg.photons``) photon slots per light in
    chunks of ``cfg.ray_chunk`` slots.  Returns per-slot arrays; ``stored``
    is the success mask.

    ``differentiable=False`` (the render path) runs under
    ``torch.no_grad()`` and stops a chunk's retry rounds once every slot
    stored.  ``differentiable=True`` keeps autograd on and runs exactly
    ``cfg.photon_retries`` rounds, so the stored photons' colours and
    positions carry gradients to the light and material parameters (hit
    selection detached); on the slots both store, the two batches are
    equal for the same ``uniform`` draws."""
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()), \
            telemetry.span("photons"):
        return _trace_photons(scene, cfg, sampler, count, uniform,
                              differentiable)


def _trace_photons(scene, cfg, sampler, count, uniform, differentiable,
                   mesh=None):
    """The pass in chunks of ``cfg.ray_chunk`` slots, or with ``mesh`` this
    rank's chunk of count / ranks slots, all-gathered; each light's rounds
    on ``routes.photon_round``'s route, given its round-kernel constants
    (``_light_row``) on the kernel's."""
    sampler = sampler or HaltonSampler()
    count = count or cfg.photons
    uniform = uniform or ThreefryUniform(cfg.seed, scene.device)
    L = scene.lights.count
    if L == 0:          # one empty slot
        z = torch.zeros((1, 3), dtype=scene.lights.pos.dtype,
                        device=scene.device)
        return PhotonBatch(z, z, z, torch.zeros(1, dtype=torch.bool,
                                                device=scene.device))
    route = routes.photon_round(scene, cfg, sampler, uniform,
                                differentiable)[0]
    lights = [_light_row(scene, li, count) if route == "k2" else None
              for li in range(L)]
    if mesh is None:
        per = min(max(cfg.ray_chunk, 1), count)
        starts = range(0, count, per)
    elif count % mesh.size:
        raise ValueError(f"photon count {count} not divisible by "
                         f"{mesh.size}")
    else:
        from ..parallel.mesh import all_gather
        per = count // mesh.size
        starts = [mesh.rank * per]
    parts = []
    for li in range(L):
        for start in starts:
            b = _emit_chunk(scene, cfg, sampler, uniform, start // per, start,
                            li, min(per, count - start), count,
                            differentiable, lights[li])
            parts.append(b if mesh is None else PhotonBatch(
                *(all_gather(mesh, f) for f in b)))
    return PhotonBatch(*(torch.cat([getattr(p, f) for p in parts])
                         for f in PhotonBatch._fields))


@torch.no_grad()
def trace_photons_sharded(scene, cfg: RenderConfig, mesh, sampler=None,
                          count=None, uniform=None) -> PhotonBatch:
    """``trace_photons`` with the slots split over the ranks of ``mesh``
    (``parallel.mesh.Mesh``): rank r emits slots [r*per, (r+1)*per) of
    each light as chunk r (per = count / ranks), and the ranks' batches
    are all-gathered, so every rank returns the batch ``trace_photons``
    gives with ``cfg.ray_chunk = per``."""
    return _trace_photons(scene, cfg, sampler, count, uniform, False, mesh)


@torch.no_grad()
def build_photon_map(batch: PhotonBatch, world_min, world_max,
                     target_per_cell: float = 4.0, max_dim: int = 1024,
                     window_cap: int | None = None, window_cap_max: int = 96,
                     max_cells: int = 33_554_432) -> PhotonMap:
    """Sort photons into a uniform grid fitted to the stored photons.

    Per-axis resolution follows the photon extent (a planar caustic sheet
    gets a thin axis).  With ``window_cap=None`` the grid is refined by
    halving the cell size until the densest cell holds at most
    ``window_cap_max`` photons (or refinement stops helping, or the cell
    budget is reached), and ``window_cap`` becomes that occupancy."""
    with telemetry.span("photons.grid"):
        return _build_photon_map(batch, world_min, world_max,
                                 target_per_cell, max_dim, window_cap,
                                 window_cap_max, max_cells)


def _densest_cell(cid, C: int) -> int:
    """The most photons in one of the C cells (``cid`` C: no cell), a
    histogram of the grid's cells freed on return."""
    with telemetry.sync("grid.mask"):
        in_cells = cid[cid < C]
    # bincount reads its input's least and largest value: two syncs
    with telemetry.sync("grid.bincount.min"), \
            telemetry.sync("grid.bincount.max"):
        occ = torch.bincount(in_cells, minlength=1)
    with telemetry.sync("grid.occupancy"):
        return int(occ.max())


def _build_photon_map(batch, world_min, world_max, target_per_cell, max_dim,
                      window_cap, window_cap_max, max_cells):
    dev = batch.pos.device
    dt = batch.pos.dtype
    # each sync span below marks one wait of the host for the card (a read
    # of a result, a copy of a host array to the card)
    with telemetry.sync("grid.count"):
        n_stored = max(int(batch.stored.sum()), 1)
    with telemetry.sync("grid.stored"):
        stored_np = batch.stored.cpu().numpy()
    with telemetry.sync("grid.pos"):
        pos_np = batch.pos.cpu().numpy().astype(np.float64)
    if stored_np.any():
        pmin = pos_np[stored_np].min(0)
        pmax = pos_np[stored_np].max(0)
    else:
        pmin = np.asarray(world_min, np.float64)
        pmax = np.asarray(world_max, np.float64)
    span = np.maximum(pmax - pmin, 0.0)
    pad_w = np.maximum(span.max() * 1e-3, 1e-6)
    wmin = pmin - pad_w
    extent = np.maximum(span + 2 * pad_w, 1e-6)

    n_cells_target = max(n_stored / target_per_cell, 1.0)
    h = float((np.prod(extent) / n_cells_target) ** (1 / 3))
    with telemetry.sync("grid.origin"):
        wmin_t = torch.tensor(wmin, dtype=dt, device=dev)

    def dims_of(h):
        d = np.clip(np.ceil(extent / h).astype(np.int64), 1, max_dim)
        return tuple(int(x) for x in d)

    def cell_ids(h):
        dims = dims_of(h)
        inv_cell = np.asarray(dims) / extent
        with telemetry.sync("grid.scale"):
            scale = torch.tensor(inv_cell, dtype=dt, device=dev)
        with telemetry.sync("grid.dims"):
            hi = torch.tensor(np.asarray(dims) - 1, dtype=torch.int32,
                              device=dev)
        gi = torch.minimum(torch.clamp(((batch.pos - wmin_t) * scale)
                                       .to(torch.int32), min=0), hi).long()
        cid = (gi[:, 0] * dims[1] + gi[:, 1]) * dims[2] + gi[:, 2]
        C = dims[0] * dims[1] * dims[2]
        return torch.where(batch.stored, cid, C), dims, inv_cell, C

    if window_cap is None:
        prev = None
        while True:
            cid, dims, inv_cell, C = cell_ids(h)
            occ_max = _densest_cell(cid, C)
            if occ_max <= window_cap_max:
                break
            if prev is not None and occ_max >= prev[1]:
                h = prev[0]    # refinement stopped helping: undo it
                cid, dims, inv_cell, C = cell_ids(h)
                break
            nxt = dims_of(h / 2)
            if (np.prod(np.asarray(nxt, np.int64)) > max_cells
                    or nxt == dims):
                break
            prev = (h, occ_max)
            h = h / 2
        window_cap = int(np.clip(occ_max, 1, window_cap_max))
    else:
        cid, dims, inv_cell, C = cell_ids(h)

    order = torch.argsort(cid, stable=True)
    cell_start = torch.searchsorted(
        cid[order], torch.arange(C + 1, dtype=cid.dtype, device=dev),
        side="left").to(torch.int32)
    with telemetry.sync("grid.scale"):
        inv_cell_t = torch.tensor(inv_cell, dtype=dt, device=dev)
    return PhotonMap(pos=batch.pos[order], dir=batch.dir[order],
                     col=batch.col[order], valid=batch.stored[order],
                     cell_start=cell_start, grid_min=wmin_t,
                     inv_cell=inv_cell_t, order=order.to(torch.int32),
                     dims=dims, window_cap=window_cap)


KNN_BACKENDS = ("auto", "pallas", "chunkrow", "jnp")


def sample_photons_backend(pm: PhotonMap, point, direction, k,
                           backend: str = "auto", plain: bool = False):
    """The caustic estimate ``backend`` (``cfg.knn_backend``) names, as the
    JAX package's ``photon.sample_photons_backend`` dispatches it:

    * ``"auto"`` and ``"pallas"``: the whole-window estimate of the TPU kNN
      kernels, ``sample_photons_tiled`` (the kNN kernel on CUDA tensors,
      its plain version on CPU tensors: one function on both devices);
    * ``"chunkrow"``: the same whole-window estimate.  JAX's chunk-row
      path fetches a window as rows of 32 photons, at most 96 of them
      (past that, the capped estimator), a budget of the TPU's layout that
      the port does not keep (ROADMAP A.11);
    * ``"jnp"``: ``sample_photons``, the capped per-point estimator, in
      plain torch on any device, as JAX's ``"jnp"`` reaches no kernel.

    ``plain=True`` runs the backend's plain version on any device."""
    if backend not in KNN_BACKENDS:
        raise ValueError(f"knn_backend {backend!r} not in {KNN_BACKENDS}")
    if backend == "jnp":
        return sample_photons(pm, point, direction, k)
    if plain:
        return sample_photons_plain(pm, point, direction, k)
    return sample_photons_tiled(pm, point, direction, k)
