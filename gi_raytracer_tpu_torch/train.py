"""The inverse-rendering train step of the root ``bench.py``
(``train_step_seconds``, its first rung), shared by the port's bench,
``chip_smoke.py`` and the sharded step of ``parallel.mesh``.

One staged wave (K2 every trace and K3 every caustic estimate on the
card; the kNN backward is the plain estimator's VJP) of a size x size
frame at 1 spp, depth ``depth``, with a photon map of the first
``photons`` slots of a photon batch; loss mean((c - 0.25)^2) over the
wave's radiance; gradients to the photon colours (``pcol``) and the
light colour (``lcol``, broadcast to every light).  Lane ids are
0..R-1 in block order, as ``bench.py``'s ``lane2``.
"""

from __future__ import annotations

import dataclasses

import torch

from . import telemetry
from .render.integrator import Renderer, radiance_wave
from .render.photon import PhotonBatch, build_photon_map

TARGET = 0.25


class TrainStep:
    """``step()`` -> (loss, d loss / d pcol, d loss / d lcol)."""

    def __init__(self, scene, camera, cfg, batch: PhotonBatch,
                 size: int = 256, depth: int = 8, photons: int = 50_000):
        self.scene = scene
        self.cfg = cfg.replace(min_samples=1, max_samples=1,
                               max_depth=depth)
        self.size = size
        small = PhotonBatch(*(t[:photons] for t in batch))
        self.n_stored = int(small.stored.sum())
        self.photon_map = build_photon_map(
            small, scene.world_min.cpu().numpy(),
            scene.world_max.cpu().numpy())
        self.inputs = Renderer(scene, camera, self.cfg, size,
                               size).wave_inputs(0)
        self.lane = torch.arange(self.inputs[0].shape[0],
                                 device=scene.device)
        self.target = torch.full_like(self.inputs[0], TARGET)

    def params(self) -> dict:
        """The step's parameters, as the scene and map hold them."""
        return {"pcol": self.photon_map.col, "lcol": self.scene.lights.col[0]}

    def build(self, p: dict):
        """(scene, photon map) around parameters ``p``."""
        lights = self.scene.lights
        lit = dataclasses.replace(self.scene, lights=dataclasses.replace(
            lights, col=p["lcol"].expand_as(lights.col)))
        return lit, dataclasses.replace(self.photon_map, col=p["pcol"])

    def __call__(self, plain: bool = False):
        with telemetry.span("train.step"):
            p = {k: v.detach().clone().requires_grad_(True)
                 for k, v in self.params().items()}
            scene, pm = self.build(p)
            c, _ = radiance_wave(scene, self.cfg, *self.inputs, 0, pm,
                                 lane_ids=self.lane, plain=plain)
            loss = torch.mean((c - self.target) ** 2)
            return (loss.detach(),) + torch.autograd.grad(
                loss, (p["pcol"], p["lcol"]))

    def sgd(self, lr: float = 0.05) -> tuple:
        """(loss, params after one SGD step): the single-process twin of
        ``parallel.mesh.train_step_sharded``."""
        loss, g_pcol, g_lcol = self()
        p = self.params()
        return loss, {"pcol": p["pcol"] - lr * g_pcol,
                      "lcol": p["lcol"] - lr * g_lcol}
