"""The bounce megakernel (K1): wrapper, tables and the caustic estimate.

Counterpart of ``gi_raytracer_tpu.ops.pallas_megakernel``.  One launch of
``csrc/megakernel.cu`` runs a whole radiance wave: every bounce's closest
hit, shading, secondary direction, shadow rays, direct light, Russian
roulette and accumulation, plus one caustic query record per bounce.  The
records then go through the kNN kernel (:func:`_caustic_estimate`).
The kernel walks the scene's 128-row chunks, skipping those whose boxes a
ray does not enter before its best hit, with each (ray, chunk) pair tested
by a whole warp; its tables (:func:`build_mega_tables`) are the shade
rows, the feature rows as four planes, the accept column and the chunk
boxes.  :func:`mega_info` reports the kernel's resources on the card.

The plain version is the staged ``integrator.radiance_wave`` (the same
estimator and random streams, built on the plain trace):
``radiance_wave_mega`` takes it for CPU tensors and launches the kernel
for CUDA tensors.  Scope: triangle-only scenes, no fog, no image textures,
<= 4 lights, depth <= 16, float32 (``mega_why_not``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import telemetry
from ..render.shading import build_prim_rows, PR_IOR, PR_W
from ..scene.types import dataclass_tensors, derived
from . import _cuda
from . import cuda_intersect as ci
from .intersect import chunk_boxes, trace_tables

MEGA_TRI_CAP = 24_000
MAX_DEPTH = 16
MAX_LIGHTS = 4
FAR = 1e29        # caustic records at or past this x are dead slots


def mega_eligible(scene, cfg) -> bool:
    return not mega_why_not(scene, cfg)


def mega_why_not(scene, cfg) -> list:
    """The failed eligibility conditions (empty = eligible)."""
    why = []
    if not (0 < scene.n_tris <= MEGA_TRI_CAP):
        why.append(f"n_tris {scene.n_tris} not in (0, {MEGA_TRI_CAP}]")
    if scene.n_spheres != 0:
        why.append(f"{scene.n_spheres} analytic spheres")
    if scene.n_cones != 0:
        why.append(f"{scene.n_cones} analytic cones")
    if scene.has_fog:
        why.append("fog")
    if scene.has_image_tex:
        why.append("image textures")
    if scene.lights.count > MAX_LIGHTS:
        why.append(f"{scene.lights.count} lights > {MAX_LIGHTS}")
    if cfg.dtype != "float32":
        why.append(f"dtype {cfg.dtype}")
    if cfg.max_depth > MAX_DEPTH:
        why.append(f"max_depth {cfg.max_depth} > {MAX_DEPTH}")
    return why


def build_mega_tables(scene):
    """((T_pad, 64) attr rows, (4, T_pad, 4) MT features as four planes of
    16-byte quads, (T_pad,) accept values, (8, T_pad / 128) chunk boxes).
    Pad rows set PR_IOR to 1 (with opacity 0 the accept probability is 0)
    and have zero geometry, so they never pass the test."""
    rows = build_prim_rows(scene).detach().float()
    pad = (-rows.shape[0]) % ci.TRI_PAD
    if pad:
        prow = torch.zeros((pad, PR_W), dtype=rows.dtype, device=rows.device)
        prow[:, PR_IOR] = 1.0
        rows = torch.cat([rows, prow], 0)
    feat, accept = trace_tables(scene)
    planes = feat.view(-1, 4, 4).transpose(0, 1).contiguous()
    return rows.contiguous(), planes, accept, chunk_boxes(scene)


def mega_tables(scene):
    """``build_mega_tables``, kept on the Scene object and built again after
    its tensors change (``types.derived``)."""
    return derived(scene, "_mega_tables", scene.table_sources(),
                   lambda: build_mega_tables(scene))


def _needs_grad(scene, ro, rd, photon_map) -> bool:
    """Whether autograd would want a gradient through the wave: grad mode
    on, and a scene leaf, the rays or the map's photons requiring one."""
    if not torch.is_grad_enabled():
        return False
    ts = scene.table_sources() + dataclass_tensors(scene.lights) + [ro, rd]
    if photon_map is not None:
        ts += [photon_map.pos, photon_map.dir, photon_map.col]
    return any(t.requires_grad for t in ts)


def radiance_wave_mega(scene, cfg, ro, rd, sx_all, sy_all, lane_u32,
                       wave_salt=0, photon_map=None, tests=None):
    """One radiance wave: (radiance (R,3), (n_closest, n_shadow)).

    ``sx_all``/``sy_all`` (D, R) are the per-bounce BSDF samples, ``lane_u32``
    (R,) the global lane ids keying every stochastic stream.  Kernel
    measurements only: ``tests``, a (2,) int64 CUDA tensor, receives the
    ray-triangle tests the closest and the shadow walks made."""
    why = mega_why_not(scene, cfg)
    if why:
        raise ValueError("scene is not megakernel-eligible: " + "; ".join(why))
    if _needs_grad(scene, ro, rd, photon_map):
        raise ValueError(
            "the megakernel is forward-only and its image carries no "
            "gradient: gradient paths call the staged radiance_wave "
            "(Renderer._wave)")
    if ro.device.type == "cpu":
        if tests is not None:
            raise ValueError("test counts are the kernel's; the plain wave "
                             "has none")
        from ..render.integrator import radiance_wave
        return radiance_wave(scene, cfg, ro, rd, sx_all, sy_all, wave_salt,
                             photon_map, lane_ids=lane_u32)
    return _mega_cuda(scene, cfg, ro, rd, sx_all, sy_all, lane_u32,
                      wave_salt, photon_map, tests)


def mega_info(scene) -> dict:
    """K1's resources on the card for the scene's table: resident blocks
    per SM, registers and local (spill) bytes per thread, dynamic and
    static shared bytes per block, whether the feature table is walked
    from shared memory, and threads per block."""
    out = (ctypes.c_int * 7)()
    t_pad = mega_tables(scene)[0].shape[0]
    _cuda.check(_cuda.lib().gi_mega_info(t_pad, ctypes.addressof(out)),
                "gi_mega_info")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "dynamic_smem", "static_smem", "table_in_smem",
                     "threads"), list(out)))


@torch.no_grad()
def _mega_cuda(scene, cfg, ro, rd, sx_all, sy_all, lane_u32, wave_salt,
               photon_map, tests=None):
    R = ro.shape[0]
    D = int(cfg.max_depth)
    L = scene.lights.count
    dev = ro.device
    attr, planes, accept, cbox = mega_tables(scene)
    t_pad = attr.shape[0]
    lights = torch.cat([scene.lights.pos, scene.lights.col,
                        scene.lights.rad[:, None],
                        torch.zeros((L, 1), device=dev)], 1).float().contiguous()
    ro_c = ro.float().contiguous()
    rd_c = rd.float().contiguous()
    sx = sx_all.float().contiguous()
    sy = sy_all.float().contiguous()
    if sx.shape != (D, R) or sy.shape != (D, R):
        raise ValueError(f"sx_all/sy_all must be ({D}, {R})")
    rid = (lane_u32.to(torch.int64) & 0xFFFFFFFF).to(torch.int32).contiguous()
    _cuda.require_cuda("radiance_wave_mega", ro_c, rd_c, sx, sy, rid, attr,
                       planes, accept, cbox, lights)
    for what, t, shape in (("ro", ro_c, (R, 3)), ("rd", rd_c, (R, 3)),
                           ("lane ids", rid, (R,)),
                           ("attr", attr, (t_pad, PR_W)),
                           ("features", planes, (4, t_pad, 4)),
                           ("accept", accept, (t_pad,)),
                           ("chunk boxes", cbox, (8, t_pad // ci.CHUNK_ROWS)),
                           ("lights", lights, (L, 8))):
        _cuda.require_shape(f"radiance_wave_mega {what}", t, shape)
    if tests is not None:
        _cuda.require_cuda("radiance_wave_mega tests", tests)
        _cuda.require_shape("radiance_wave_mega tests", tests, (2,))
        if tests.dtype != torch.int64:
            raise ValueError("radiance_wave_mega tests: expected int64")
    with_caustic = photon_map is not None
    out = torch.empty((R, 8), dtype=torch.float32, device=dev)
    rec = (torch.empty((R, D, 9), dtype=torch.float32, device=dev)
           if with_caustic else None)
    if R == 0:
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return torch.zeros((0, 3), dtype=ro.dtype, device=dev), (z, z)
    queue = torch.empty(1, dtype=torch.int32, device=dev)
    amb = [float(a) for a in cfg.ambient]
    code = _cuda.lib().gi_mega_launch(
        ro_c.data_ptr(), rd_c.data_ptr(), sx.data_ptr(), sy.data_ptr(),
        rid.data_ptr(), attr.data_ptr(), planes.data_ptr(),
        accept.data_ptr(), cbox.data_ptr(), lights.data_ptr(),
        R, t_pad, D, L, int(wave_salt) & 0xFFFFFFFF,
        float(cfg.epsilon), float(cfg.shadow_bias),
        int(cfg.min_depth), amb[0], amb[1], amb[2], int(scene.all_opaque),
        int(with_caustic), int(cfg.caustic_max_depth),
        out.data_ptr(), rec.data_ptr() if with_caustic else None,
        queue.data_ptr(), tests.data_ptr() if tests is not None else None,
        _cuda.stream_ptr(dev))
    _cuda.check(code, "gi_mega_launch")
    _cuda.launches["megakernel"] += 1

    radiance = out[:, 0:3]
    n_closest = out[:, 3].sum().to(torch.int64)
    n_shadow = out[:, 4].sum().to(torch.int64)
    if with_caustic:
        pts = rec[:, :, 0:3].reshape(R * D, 3)
        dirs = rec[:, :, 3:6].reshape(R * D, 3)
        wts = rec[:, :, 6:9].reshape(R * D, 3)
        est = _caustic_estimate(photon_map, cfg, pts, dirs, wts)
        radiance = radiance + (wts * est).reshape(R, D, 3).sum(1)
    return radiance.to(ro.dtype), (n_closest, n_shadow)


def _caustic_estimate(photon_map, cfg, pts, dirs, wts):
    """kNN caustic estimate over the per-bounce query records, with the
    dead slots (far-sentinel points, zero weight) compacted out first."""
    from ..render.photon import sample_photons_backend

    with telemetry.sync("mega.live"):
        live = torch.nonzero((pts[:, 0] < FAR)
                             & (wts.max(dim=-1).values > 0)).squeeze(1)
    est = torch.zeros_like(pts)
    if live.numel():
        est[live] = sample_photons_backend(photon_map, pts[live], dirs[live],
                                           cfg.knn_k, cfg.knn_backend)
    return est
