"""The frame: one ``Renderer.render()`` of the program to the finished
image at the traffic's fixed spp, frame after frame from one caller.

Traffic keys: ``width``, ``height``, ``spp``, ``depth``, ``knn_k``,
``photons`` (slots of the map built in set-up; 0 for none), ``ray_chunk``
and ``check_blocks`` (the 16x16 pixel blocks the reference renders).

Set-up builds the scene, the photon map (seeded by the run's seed) and
the renderer, and renders one frame.  The window renders frames; every
frame is the same work on the same inputs.  After the window the first
and the last frame are judged at ``check_blocks`` blocks drawn from the
seed, against the reference's own scene, photon map and frame there;
the map's photons are judged slot by slot against the reference's batch.
"""

from __future__ import annotations

import torch

from ..core import k3count, peaks
from . import common

IMG_TOL = 1e-3     # a pixel is off past IMG_TOL * (1 + its largest channel)


class State:
    pass


def setup(run):
    from gi_raytracer_tpu_torch.config import RenderConfig
    from gi_raytracer_tpu_torch.render import Renderer
    from gi_raytracer_tpu_torch.render.photon import (build_photon_map,
                                                      trace_photons)
    tr = run.cell.traffic
    s = State()
    s.scene = common.program_scene(run)
    s.cfg = common.render_config(RenderConfig, tr, run.seed)
    s.pm = None
    if int(tr.get("photons", 0)):
        batch = trace_photons(s.scene, s.cfg)
        s.pm = build_photon_map(batch, s.scene.world_min.cpu().numpy(),
                                s.scene.world_max.cpu().numpy())
        del batch
    s.renderer = Renderer(s.scene, common.program_camera(run), s.cfg,
                          int(tr["width"]), int(tr["height"]),
                          photon_map=s.pm)
    s.renderer.render()
    s.first = s.last = s.rays = None
    return s


def job(s, i: int) -> int:
    img, st = s.renderer.render(return_state=True)
    if s.first is None:
        s.first = img
    s.last, s.rays = img, st["rays"]
    return 1


def after_window(s, run):
    """Read the window's counters, count the yardstick's work of a frame
    (a traced run renders one more frame, untimed, to collect K3's
    queries), and free everything but the answers."""
    tr = run.cell.traffic
    run.counts["rays_per_frame"] = float(s.rays)
    run.work["tris"] = s.scene.n_tris
    run.work["lights"] = s.scene.lights.count
    run.work["lanes_per_wave"] = int(tr["width"]) * int(tr["height"])
    run.work["waves_per_frame"] = int(tr["spp"])
    run.work["depth"] = int(tr["depth"])
    if run.trace and s.pm is not None:
        run.work["k3"] = _k3_frame_work(s)
    ans = {"first": s.first, "last": s.last}
    if s.pm is not None:
        ans["pm"] = common.batch_of_map(s.pm)
    return ans


def _k3_frame_work(s) -> dict:
    """K3's work over the queries of one frame: each call's least time
    (``peaks.bound`` of its operations and bytes), summed."""
    from gi_raytracer_tpu_torch.render import photon as photon_mod
    calls = []
    orig = photon_mod.sample_photons_backend

    def record(pm, point, direction, k, *a, **kw):
        calls.append((point, k))
        return orig(pm, point, direction, k, *a, **kw)
    photon_mod.sample_photons_backend = record
    try:
        s.renderer.render()
    finally:
        photon_mod.sample_photons_backend = orig
    least, by = 0.0, {}
    for pts, k in calls:
        o, b, _ = k3count.k3_work(s.pm, pts.float(), k)
        t, which = peaks.bound(o, b)
        least += t
        by[which] = by.get(which, 0) + 1
    return {"least_s": least, "calls": len(calls), "bound_by": by}


def _blocks(run):
    tr = run.cell.traffic
    n = (int(tr["width"]) // 16) * (int(tr["height"]) // 16)
    return torch.as_tensor(common.draw(run.seed, n, int(tr["check_blocks"]),
                                       1), device=run.device)


def reference(run, ans=None):
    """The reference's photon batch (if the traffic has a map) and its
    frame at the drawn blocks: {"batch", "pix", "img"}."""
    from ..ref.config import RenderConfig
    from ..ref.integrator import Frame
    from ..ref.photon import build_photon_map, trace_photons
    tr = run.cell.traffic
    scene = common.ref_scene(run)
    cfg = common.render_config(RenderConfig, tr, run.seed)
    out, pm = {"batch": None}, None
    if int(tr.get("photons", 0)):
        batch = trace_photons(scene, cfg)
        out["batch"] = (batch.pos, batch.stored)
        pm = build_photon_map(batch, scene.world_min.cpu().numpy(),
                              scene.world_max.cpu().numpy())
        out["map"] = pm
    frame = Frame(scene, common.ref_camera(run), cfg, int(tr["width"]),
                  int(tr["height"]), photon_map=pm)
    blocks = _blocks(run)
    img, rays = frame.render_blocks(blocks)
    out["pix"] = frame.pixels(frame.block_positions(blocks))
    out["img"] = img
    # the yardstick's rays a frame (K1's and K4's rooflines): the blocks'
    # closest-hit and shadow rays, scaled to the whole frame
    run.work["ref_rays_per_frame"] = (float(rays.sum()) * frame.n_blocks
                                      / blocks.numel())
    return out


def compare(ans, ref) -> dict:
    """The numbers judged, each the worse of the first and last frame."""
    got = {}
    if ref["batch"] is not None:
        got["photon_off"] = common.photon_off(*ans["pm"], *ref["batch"])
    r = ref["img"]
    rel, off = [], []
    for key in ("first", "last"):
        p = ans[key].reshape(-1, 3)[ref["pix"]].to(r.dtype)
        d = (p - r).abs()
        rel.append(float(d.sum() / r.abs().sum().clamp(min=1e-30)))
        off.append(float((d.amax(-1) > IMG_TOL * (1 + r.abs().amax(-1)))
                         .float().mean()))
    got["img_rel_l1"] = max(rel)
    got["pix_off"] = max(off)
    return got


def control(run):
    """The reference in bfloat16 put in the program's place, as answers."""
    from ..ref import precision
    with precision.bfloat16():
        low = reference(run)
    tr = run.cell.traffic
    img = torch.zeros((int(tr["width"]) * int(tr["height"]), 3),
                      dtype=low["img"].dtype, device=run.device)
    img[low["pix"]] = low["img"]
    ans = {"first": img, "last": img}
    if low["batch"] is not None:
        ans["pm"] = common.batch_of_map(low["map"])
    return ans
