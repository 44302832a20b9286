"""The gradient step: one ``train.TrainStep`` call of the program, step
after step from one caller: one staged wave of a size x size frame at 1
spp, the caustic estimate on a photon map, the loss mean((c - 0.25)^2)
over the wave's radiance, and its gradients to the photon colours and the
light colour.

Traffic keys: ``size``, ``depth``, ``knn_k``, ``photons`` (the map's
slots: set-up traces exactly that many, one pass seeded by the run's
seed, and the map holds them all).

The step updates nothing, so every step of the window is the same work
on the same state.  After the window the last step's loss and gradients
are judged against the reference's own photon pass, map, wave and
autograd: the loss by its gap (``loss_gap``), each gradient by the gap
of its norm (``lcol_gap``, ``pcol_gap``), and the photon colours' photon
by photon (``pcol_off``).
"""

from __future__ import annotations

import dataclasses

import torch

from . import common

TARGET = 0.25


class State:
    pass


def _cfg(run, cls):
    tr = run.cell.traffic
    return common.render_config(cls, dict(tr, spp=1), run.seed)


def setup(run):
    from gi_raytracer_tpu_torch.config import RenderConfig
    from gi_raytracer_tpu_torch.render.photon import trace_photons
    from gi_raytracer_tpu_torch.train import TrainStep
    tr = run.cell.traffic
    s = State()
    s.scene = common.program_scene(run)
    cfg = _cfg(run, RenderConfig)
    batch = trace_photons(s.scene, cfg)
    s.step = TrainStep(s.scene, common.program_camera(run), cfg, batch,
                       size=int(tr["size"]), depth=int(tr["depth"]),
                       photons=int(tr["photons"]))
    del batch
    s.step()
    s.out = None
    return s


def job(s, i: int) -> int:
    s.out = s.step()
    return 1


def after_window(s, run):
    loss, g_pcol, g_lcol = s.out
    run.work["tris"] = s.scene.n_tris
    return {"loss": loss,
            "g_pcol": common.in_slot_order(g_pcol, s.step.photon_map.order),
            "g_lcol": g_lcol}


def reference(run, ans=None, half=False):
    """The reference's loss and gradients of the same step (``half``: of
    its first half of lanes alone, the planted fault of a batch half left
    out)."""
    from ..ref.config import RenderConfig
    from ..ref.integrator import Frame, radiance_wave
    from ..ref.photon import build_photon_map, trace_photons
    tr = run.cell.traffic
    scene = common.ref_scene(run)
    cfg = _cfg(run, RenderConfig)
    batch = trace_photons(scene, cfg)
    pm = build_photon_map(batch, scene.world_min.cpu().numpy(),
                          scene.world_max.cpu().numpy())
    cfg = cfg.replace(min_samples=1, max_samples=1,
                      max_depth=int(tr["depth"]))
    size = int(tr["size"])
    inputs = Frame(scene, common.ref_camera(run), cfg, size,
                   size).wave_inputs(0)
    if half:
        h = inputs[0].shape[0] // 2
        ro, rd, sx, sy = inputs
        inputs = (ro[:h], rd[:h], sx[:, :h], sy[:, :h])
    lane = torch.arange(inputs[0].shape[0], device=run.device)
    pcol = pm.col.detach().clone().requires_grad_(True)
    lcol = scene.lights.col[0].detach().clone().requires_grad_(True)
    with torch.enable_grad():
        lights = dataclasses.replace(scene.lights,
                                     col=lcol.expand_as(scene.lights.col))
        c, _ = radiance_wave(dataclasses.replace(scene, lights=lights), cfg,
                             *inputs, photon_map=dataclasses.replace(
                                 pm, col=pcol), lane_ids=lane)
        loss = torch.mean((c - TARGET) ** 2)
        g_pcol, g_lcol = torch.autograd.grad(loss, (pcol, lcol))
    return {"loss": loss.detach(),
            "g_pcol": common.in_slot_order(g_pcol, pm.order),
            "g_lcol": g_lcol}


# a photon's colour gradient is off past this share of its own size plus
# the median photon's
PCOL_TOL = 0.01


def _gap(a, r) -> float:
    """| |a| - |r| | / |r|."""
    a, r = a.double(), r.double()
    return float((a.norm() - r.norm()).abs() / r.norm().clamp(min=1e-30))


def compare(ans, ref) -> dict:
    """``loss_gap``: | loss - loss_ref | / | loss_ref |; ``lcol_gap`` and
    ``pcol_gap``: | |g| - |g_ref| | / |g_ref| of the light colour's and
    the photon colours' gradients; ``pcol_off``: the share of photon
    slots whose colour gradient is off by more than ``PCOL_TOL`` (|g_ref|
    + the median |g_ref| of the photons that have one), largest
    channel."""
    got = {"loss_gap": _gap(ans["loss"], ref["loss"]),
           "lcol_gap": _gap(ans["g_lcol"], ref["g_lcol"]),
           "pcol_gap": _gap(ans["g_pcol"], ref["g_pcol"])}
    g, r = ans["g_pcol"].double(), ref["g_pcol"].double()
    size = r.abs().amax(-1)
    moved = size[size > 0]
    mid = moved.median() if moved.numel() else size.new_zeros(())
    off = (g - r).abs().amax(-1) > PCOL_TOL * (size + mid)
    got["pcol_off"] = float(off.double().mean())
    return got


def control(run):
    """The reference's step in bfloat16 put in the program's place."""
    from ..ref import precision
    with precision.bfloat16():
        return reference(run)


def fault(run, name):
    """The reference with a fault planted, put in the program's place:
    ``half``, the step over half of its lanes, the mean over the rest."""
    if name != "half":
        raise ValueError(f"no fault {name!r} for a step")
    return reference(run, half=True)
