"""The port's slice end to end: the JAX Renderer (megakernel, interpret
mode) against the port's Renderer.render on the same scene and photon map;
and the port package imports no JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.render import Camera as JaxCamera
from gi_raytracer_tpu.render.integrator import Renderer as JaxRenderer
from gi_raytracer_tpu.render.photon import (trace_photons as jax_trace,
                                            build_photon_map as jax_build_map)
from gi_raytracer_tpu_torch import convert
from gi_raytracer_tpu_torch.render import Camera, Renderer
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
from gi_raytracer_tpu_torch.scene.cornell import (cornell_box, CAMERA_POS,
                                                  CAMERA_LOOK_AT)

from _torch_parity import (jax_cornell, port_scene, port_map,
                           TEST_CAMERA_POS, TEST_CAMERA_LOOK_AT)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_render_matches_jax_megakernel_renderer():
    """Fixed 2 spp, depth 4, 32x32, with the JAX photon pass's map carried
    across: pixels within 1e-4 on >= 99.9%, ray counter within 0.05%.

    Where the two differ, it is by the last bits of a caustic query point:
    the jitted reference fuses its float arithmetic, the port runs it op by
    op (it matches the reference run under ``jax.disable_jit`` bit for
    bit).  The kNN estimate jumps where the query's grid cell or its k-th
    neighbour changes, so a query close to such an edge can select other
    photons, and its pixel moves by more than 1e-4.  That happens on about
    0.1% of lanes, so the gate (at most one pixel of 1,024) depends on the
    map: with 2,048, 4,096, 8,192 and 16,384 photons 1, 2, 0 and 2 pixels
    moved.  The map here has 8,192."""
    js = jax_cornell(False)
    ts = port_scene(js)
    jcfg = JaxConfig(min_samples=2, max_samples=2, max_depth=4,
                     adaptive=False, integrator="mega", knn_backend="jnp",
                     photons=8192)
    batch = jax_trace(js, jcfg)
    jpm = jax_build_map(batch, np.asarray(js.world_min),
                        np.asarray(js.world_max))
    want, wst = JaxRenderer(
        js, JaxCamera(pos=TEST_CAMERA_POS, look_at=TEST_CAMERA_LOOK_AT),
        jcfg, 32, 32, photon_map=jpm).render(return_state=True)

    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    got, st = Renderer(
        ts, Camera(pos=TEST_CAMERA_POS, look_at=TEST_CAMERA_LOOK_AT), cfg,
        32, 32, photon_map=port_map(jpm)).render(return_state=True)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == (32, 32, 3) and np.isfinite(got).all()
    assert st["wave"] == 2
    close = (np.abs(got - want) <= 1e-4).all(-1)
    assert close.mean() >= 0.999, close.mean()
    rays_w, rays_g = float(wst["rays"]), float(st["rays"])
    assert abs(rays_g - rays_w) <= 5e-4 * rays_w, (rays_g, rays_w)


def test_cornell_camera_render_has_wall_colours():
    """The main path's camera (outside the box, at z = -14): the red wall
    is on the image's left, the blue wall on its right."""
    scene = cornell_box(SceneBuilder, meshgen, False).build(device="cpu")
    cfg = convert.config_from_dict(dict(
        dataclasses.asdict(JaxConfig()), min_samples=2, max_samples=2,
        max_depth=3, adaptive=False))
    img = Renderer(scene, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT), cfg,
                   24, 24).render()
    assert torch.isfinite(img).all() and img.mean() > 0.02
    left = img[8:16, 3:6].mean((0, 1))
    right = img[8:16, -6:-3].mean((0, 1))
    assert left[0] > left[2] and right[2] > right[0], (left, right)


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, gi_raytracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'gi_raytracer_tpu' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
