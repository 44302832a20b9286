"""The port's default caustic estimate inside a render, against the JAX
package's TPU kNN path: the port's Renderer on ``knn_backend="auto"`` (the
whole-window estimate) against the JAX Renderer on ``"pallas"`` (the tiled
kNN kernels, in interpret mode on the CPU), on a Cornell map whose window
cap binds."""

import dataclasses

import numpy as np

from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.render import Camera as JaxCamera
from gi_raytracer_tpu.render.integrator import Renderer as JaxRenderer
from gi_raytracer_tpu.render.photon import (trace_photons as jax_trace,
                                            build_photon_map as jax_build_map)
from gi_raytracer_tpu_torch import convert
from gi_raytracer_tpu_torch.render import Camera, Renderer

from _torch_parity import (jax_cornell, port_scene, port_map,
                           TEST_CAMERA_POS, TEST_CAMERA_LOOK_AT)


def test_render_whole_window_matches_jax_pallas():
    """Fixed 2 spp, depth 4, 32x32, with the JAX photon pass's map of
    32,768 slots, whose densest cells hold more than its window cap (96);
    the render's windows are small enough for the JAX router to keep them
    on its tiled kernels, which count whole windows too.  Pixels
    within 1e-4 on >= 99.9% (the caustic-edge pixel of
    test_torch_render.py's megakernel test), and on every pixel where the
    capped estimator (the port on ``"jnp"``) moves the image, the port on
    ``"auto"`` agrees with JAX ``"pallas"``."""
    js = jax_cornell(False)
    jcfg = JaxConfig(min_samples=2, max_samples=2, max_depth=4,
                     adaptive=False, integrator="mega", knn_backend="pallas",
                     photons=32768)
    jpm = jax_build_map(jax_trace(js, jcfg), np.asarray(js.world_min),
                        np.asarray(js.world_max))
    occ = np.diff(np.asarray(jpm.cell_start))
    assert occ.max() > jpm.window_cap, (occ.max(), jpm.window_cap)
    want = np.asarray(JaxRenderer(
        js, JaxCamera(pos=TEST_CAMERA_POS, look_at=TEST_CAMERA_LOOK_AT),
        jcfg, 32, 32, photon_map=jpm).render())

    cfg = convert.config_from_dict(dict(dataclasses.asdict(jcfg),
                                        knn_backend="auto"))
    ts, pm = port_scene(js), port_map(jpm)
    cam = Camera(pos=TEST_CAMERA_POS, look_at=TEST_CAMERA_LOOK_AT)
    got = Renderer(ts, cam, cfg, 32, 32, photon_map=pm).render().numpy()
    capped = Renderer(ts, cam, cfg.replace(knn_backend="jnp"), 32, 32,
                      photon_map=pm).render().numpy()
    assert got.shape == (32, 32, 3) and np.isfinite(got).all()
    close = (np.abs(got - want) <= 1e-4).all(-1)
    assert close.mean() >= 0.999, close.mean()
    moved = (np.abs(got - capped) > 1e-4).any(-1)
    assert moved.any(), "the cap changes no pixel of this render"
    assert close[moved].all(), (np.argwhere(moved), np.argwhere(~close))
