"""Gradient validation: analytic derivatives against central finite
differences (counterpart of ``gi_raytracer_tpu.gradcheck``).

Each checker differentiates a small rendered image's mean intensity with
respect to one parameter family (light, texture and material parameters,
vertex positions, the camera position, and the light colour through the
photon map) and compares it with central finite differences of the same
deterministic estimator: the random streams are keyed on lane, purpose
and depth, so both sides of an FD step make the same stochastic
decisions.  Gradients take the staged wave (``Renderer._wave``) with the
hit selection and the photon map's structure detached, on scenes where
that estimator is exact (closed diffuse geometry, fixed lotteries), so
the tolerances can be tight.  The sizes, picks and steps are the JAX
package's.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, NamedTuple

import numpy as np
import torch

from .render.camera import Camera
from .render.integrator import Renderer


class GradReport(NamedTuple):
    name: str
    analytic: np.ndarray
    fd: np.ndarray
    rel_err: float

    @property
    def ok(self) -> bool:
        return self.rel_err < 1e-2


def _rel(g, fd):
    """Symmetric relative error; a ~0 true derivative with FD noise must not
    read as rel~1 against an analytic 0."""
    g = np.asarray(g, np.float64).ravel()
    fd = np.asarray(fd, np.float64).ravel()
    denom = np.maximum(np.maximum(np.abs(g), np.abs(fd)), 1e-3)
    return float(np.max(np.abs(g - fd) / denom))


def _fd_check(loss: Callable, param0, picks, eps):
    """(analytic, fd) at the index tuples in ``picks``: autograd of
    ``loss`` at ``param0``, and central differences of step ``eps``."""
    p = param0.detach().clone().requires_grad_(True)
    g = torch.autograd.grad(loss(p), p)[0].detach().cpu().numpy()
    fd = np.zeros(len(picks))
    ga = np.zeros(len(picks))
    with torch.no_grad():
        for n, ix in enumerate(picks):
            e = torch.zeros_like(param0)
            e[ix] = eps
            fd[n] = float((loss(param0 + e) - loss(param0 - e)) / (2 * eps))
            ga[n] = g[ix]
    return ga, fd


def _small_renderer(scene, cam, cfg, size=16):
    r = Renderer(scene, cam, cfg, size, size)
    idx = r.enum.index_image(0, device=r.device).reshape(-1)
    return r, idx


def _setup(ls, size, depth):
    cfg = ls.config.replace(adaptive=False, min_samples=1, max_samples=1,
                            max_depth=depth)
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)
    r, idx = _small_renderer(ls.scene, cam, cfg, size)
    return r, idx, ls.scene


def check_light_color(ls, size=16) -> GradReport:
    """d(image)/d(light color): the inverse-lighting path."""
    r, idx, scene = _setup(ls, size, 3)

    def loss(p):
        s = replace(scene, lights=replace(scene.lights, col=p))
        return torch.mean(r._wave(s, None, idx, 0))

    p0 = scene.lights.col
    picks = [(i, c) for i in range(min(p0.shape[0], 2)) for c in range(3)]
    ga, fd = _fd_check(loss, p0, picks, 1e-2)
    return GradReport("light_col", ga, fd, _rel(ga, fd))


def check_texture_color(ls, size=16) -> GradReport:
    """d(image)/d(texture constant color): the inverse-texture path."""
    r, idx, scene = _setup(ls, size, 3)

    def loss(p):
        s = replace(scene, textures=replace(scene.textures, color=p))
        return torch.mean(r._wave(s, None, idx, 0))

    p0 = scene.textures.color
    picks = [(i, c) for i in range(min(p0.shape[0], 3)) for c in range(3)]
    ga, fd = _fd_check(loss, p0, picks, 1e-2)
    return GradReport("texture_col", ga, fd, _rel(ga, fd))


def check_roughness(ls, size=16) -> GradReport:
    """d(image)/d(material roughness): glossy lobe and direct-light term."""
    r, idx, scene = _setup(ls, size, 3)

    def loss(p):
        s = replace(scene, materials=replace(scene.materials, roughness=p))
        return torch.mean(r._wave(s, None, idx, 0))

    p0 = scene.materials.roughness
    # only glossy and diffuse materials: mirror and glass (roughness <
    # 0.001) sit on the branch boundary of raytracer.h:492
    picks = [(int(i),) for i in np.nonzero(p0.detach().cpu().numpy()
                                           > 0.01)[0][:4]]
    ga, fd = _fd_check(loss, p0, picks, 1e-3)
    return GradReport("roughness", ga, fd, _rel(ga, fd))


def check_ior(ls, size=16) -> GradReport:
    """d(image)/d(IOR): refraction bending and Schlick fresnel."""
    r, idx, scene = _setup(ls, size, 4)

    def loss(p):
        s = replace(scene, materials=replace(scene.materials, ior=p))
        return torch.mean(r._wave(s, None, idx, 0))

    p0 = scene.materials.ior
    picks = [(int(i),) for i in np.nonzero(p0.detach().cpu().numpy()
                                           > 1.0)[0][:2]]
    if not picks:
        return GradReport("ior", np.zeros(0), np.zeros(0), 0.0)
    ga, fd = _fd_check(loss, p0, picks, 1e-3)
    return GradReport("ior", ga, fd, _rel(ga, fd))


def check_vertices(ls, size=16, n_picks=4) -> GradReport:
    """d(image)/d(vertex positions): geometry gradients through the exact
    Moller-Trumbore recompute (v0, e1, e2 and face_n rebuilt from a vertex
    tensor; the hit selection and the chunk boxes stay detached)."""
    r, idx, scene = _setup(ls, size, 2)
    tr = scene.tris
    V0 = torch.stack([tr.v0, tr.v0 + tr.e1, tr.v0 + tr.e2], dim=1)

    def loss(V):
        v0 = V[:, 0]
        e1 = V[:, 1] - V[:, 0]
        e2 = V[:, 2] - V[:, 0]
        fn = torch.linalg.cross(e1, e2, dim=-1)
        fn = fn / torch.clamp(torch.linalg.vector_norm(fn, dim=-1,
                                                       keepdim=True), 1e-30)
        s = replace(scene, tris=replace(tr, v0=v0, e1=e1, e2=e2, face_n=fn))
        return torch.mean(r._wave(s, None, idx, 0))

    rng = np.random.default_rng(0)
    T = V0.shape[0]
    picks = [(int(rng.integers(T)), int(rng.integers(3)),
              int(rng.integers(3))) for _ in range(n_picks)]
    ga, fd = _fd_check(loss, V0, picks, 1e-4)
    return GradReport("vertices", ga, fd, _rel(ga, fd))


def check_camera(ls, size=16) -> GradReport:
    """d(image)/d(camera position): sensor and primary-ray
    differentiability."""
    r, idx, scene = _setup(ls, size, 2)
    look = torch.as_tensor(ls.camera_look_at, dtype=r.dtype, device=r.device)

    def loss(campos):
        r.camera = Camera(pos=campos, look_at=look)
        return torch.mean(r._wave(scene, None, idx, 0))

    p0 = torch.as_tensor(ls.camera_pos, dtype=r.dtype, device=r.device)
    picks = [(0,), (1,), (2,)]
    ga, fd = _fd_check(loss, p0, picks, 1e-4)
    return GradReport("camera_pos", ga, fd, _rel(ga, fd))


def check_light_color_through_photons(scene, cfg, uniform=None) -> GradReport:
    """d(caustic estimate)/d(light color) through the photon pipeline:
    ``trace_photons(differentiable=True)`` -> ``PhotonMap.rebind`` -> the
    kNN estimate ``cfg.knn_backend`` names (by default its kernel forward
    on the card, the plain estimator's VJP backward): where gradients die
    silently if any stage detaches its inputs.  ``uniform`` is the
    emission's uniform source (default: the port's seeded generator, drawn
    afresh on every pass)."""
    from .render.photon import (build_photon_map, sample_photons_backend,
                                trace_photons)

    cfg = cfg.replace(photon_retries=4)
    batch0 = trace_photons(scene, cfg, uniform=uniform)
    pm0 = build_photon_map(batch0, scene.world_min.cpu().numpy(),
                           scene.world_max.cpu().numpy())
    dt, dev = batch0.pos.dtype, batch0.pos.device
    q = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.0, 0.5]], dtype=dt,
                     device=dev)
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]], dtype=dt,
                     device=dev)

    def loss(lcol):
        s = replace(scene, lights=replace(scene.lights, col=lcol))
        batch = trace_photons(s, cfg, uniform=uniform, differentiable=True)
        return torch.sum(sample_photons_backend(pm0.rebind(batch), q, d,
                                                cfg.knn_k, cfg.knn_backend))

    p0 = scene.lights.col
    picks = [(0, c) for c in range(3)]
    ga, fd = _fd_check(loss, p0, picks, 1e-2)
    return GradReport("light_col_via_photon_map", ga, fd, _rel(ga, fd))


ALL_CHECKS = {
    "light_col": check_light_color,
    "texture_col": check_texture_color,
    "roughness": check_roughness,
    "ior": check_ior,
    "vertices": check_vertices,
    "camera_pos": check_camera,
}
