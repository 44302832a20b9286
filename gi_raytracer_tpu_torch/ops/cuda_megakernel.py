"""The bounce megakernel (K1): wrapper and tables.

Counterpart of ``gi_raytracer_tpu.ops.pallas_megakernel``.  One launch of
``csrc/megakernel.cu`` runs a whole radiance wave: every bounce's closest
hit, shading, secondary direction, shadow rays, direct light, Russian
roulette and accumulation, plus one caustic query record per bounce, which
the caller folds through the kNN kernel (``render.integrator``).
The kernel walks the scene's 128-row chunks, skipping those whose boxes a
ray does not enter before its best hit, with each (ray, chunk) pair tested
by a whole warp; its tables (:func:`mega_tables`) are the shade
rows (``prim_rows.kernel_rows``), the feature rows as four planes, the
accept column and the chunk boxes.  :func:`mega_info` reports the
kernel's resources on the card.

Its plain version, the staged wave (the same estimator and random streams
on the plain trace), is the caller's (``render.integrator.dispatch_wave``),
so this module raises on anything but CUDA tensors.  Scope: ``routes.wave``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import routes
from ..scene.types import derived
from . import _cuda
from . import cuda_intersect as ci
from .intersect import chunk_boxes, trace_tables
from .prim_rows import kernel_rows, PR_W

FAR = 1e29        # caustic records at or past this x are dead slots


def mega_tables(scene):
    """((T_pad, 64) attr rows (``prim_rows.kernel_rows``), (4, T_pad, 4) MT
    features as four planes of 16-byte quads, (T_pad,) accept values,
    (8, T_pad / 128) chunk boxes), kept on the Scene object and built
    again after its tensors change (``types.derived``)."""
    def build():
        feat, accept = trace_tables(scene)
        planes = feat.view(-1, 4, 4).transpose(0, 1).contiguous()
        return kernel_rows(scene), planes, accept, chunk_boxes(scene)
    return derived(scene, "_mega_tables", scene.table_sources(), build)


@torch.no_grad()
def radiance_wave_mega(scene, cfg, ro, rd, sx_all, sy_all, lane_u32,
                       wave_salt=0, records=None, tests=None):
    """One radiance wave: ((R, 3) float32 radiance without the caustic
    term, (n_closest, n_shadow)).  ``sx_all``/``sy_all`` (D, R) are the
    per-bounce BSDF samples, ``lane_u32`` (R,) the global lane ids keying
    every stochastic stream.  ``records``, a (R, D, 9) float32 CUDA tensor,
    receives each bounce's caustic query (point, direction, weight; dead
    slots past ``FAR``); None: no caustic term.  Kernel measurements only:
    ``tests``, a (2,) int64 CUDA tensor, receives the ray-triangle tests
    the closest and the shadow walks made."""
    why = routes.wave(scene, cfg)[1]
    if why:
        raise ValueError("scene is not megakernel-eligible: " + "; ".join(why))
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
    for what, t, shape, dt in (("tests", tests, (2,), torch.int64),
                               ("records", records, (R, D, 9),
                                torch.float32)):
        if t is not None:
            _cuda.require_cuda(f"radiance_wave_mega {what}", t)
            _cuda.require_shape(f"radiance_wave_mega {what}", t, shape)
            if t.dtype != dt:
                raise ValueError(f"radiance_wave_mega {what}: expected {dt}")
    out = torch.empty((R, 8), dtype=torch.float32, device=dev)
    if R == 0:
        z = torch.zeros((), dtype=torch.int64, device=dev)
        return torch.zeros((0, 3), device=dev), (z, z)
    queue = torch.empty(1, dtype=torch.int32, device=dev)
    amb = [float(a) for a in cfg.ambient]
    code = _cuda.lib().gi_mega_launch(
        ro_c.data_ptr(), rd_c.data_ptr(), sx.data_ptr(), sy.data_ptr(),
        rid.data_ptr(), attr.data_ptr(), planes.data_ptr(),
        accept.data_ptr(), cbox.data_ptr(), lights.data_ptr(),
        R, t_pad, D, L, int(wave_salt) & 0xFFFFFFFF,
        float(cfg.epsilon), float(cfg.shadow_bias),
        int(cfg.min_depth), amb[0], amb[1], amb[2], int(scene.all_opaque),
        int(records is not None), int(cfg.caustic_max_depth), out.data_ptr(),
        None if records is None else records.data_ptr(),
        queue.data_ptr(), tests.data_ptr() if tests is not None else None,
        _cuda.stream_ptr(dev))
    _cuda.check(code, "gi_mega_launch")
    _cuda.launches["megakernel"] += 1

    return out[:, 0:3], (out[:, 3].sum().to(torch.int64),
                         out[:, 4].sum().to(torch.int64))


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
