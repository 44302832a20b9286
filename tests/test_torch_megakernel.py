"""Port parity: the megakernel's plain version (the port's
``dispatch_wave`` with ``integrator="mega"`` on CPU tensors, i.e. the staged
wave on the plain trace) against the JAX bounce megakernel in interpret mode, with the gates of
tests/test_megakernel.py: max abs error < 1e-4 and equal closest and
shadow-ray counts.  On the Cornell box (2 chunks at test size) the JAX
kernel takes its linear walk; on the 8,342-triangle glass box (66 chunks,
past its LINEAR_CHUNK_CAP) its ordered walk."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.render import Camera as JaxCamera
from gi_raytracer_tpu.render.camera import primary_rays
from gi_raytracer_tpu.render.integrator import Renderer as JaxRenderer
from gi_raytracer_tpu.render.photon import (PhotonBatch as JaxBatch,
                                            build_photon_map as jax_build_map)
from gi_raytracer_tpu.ops.pallas_megakernel import (
    radiance_wave_mega as jax_mega)
from gi_raytracer_tpu_torch import convert, routes
from gi_raytracer_tpu_torch.ops import _cuda
from gi_raytracer_tpu_torch.render.integrator import dispatch_wave

from gi_raytracer_tpu.ops.pallas_megakernel import LINEAR_CHUNK_CAP
from gi_raytracer_tpu_torch.ops.intersect import chunk_boxes
from gi_raytracer_tpu_torch.scene.cornell import cornell_box

from _torch_parity import (jax_build, jax_cornell, port_scene, port_map,
                           random_photon_batch, TEST_CAMERA_POS,
                           TEST_CAMERA_LOOK_AT)

W = H = 32          # 1,024 lanes
N_PHOTONS = 2000
GLASS_SUBDIVS = 5   # 8,192 sphere triangles, 8,342 in all


@pytest.fixture(scope="module")
def scenes():
    js = jax_cornell(False)
    return js, port_scene(js)


@pytest.fixture(scope="module")
def photon_maps(scenes):
    js, _ = scenes
    rng = np.random.default_rng(0)
    lo = np.asarray(js.world_min, np.float32)
    hi = np.asarray(js.world_max, np.float32)
    pos, d, col = random_photon_batch(rng, N_PHOTONS, lo, hi)
    jpm = jax_build_map(JaxBatch(jnp.asarray(pos), jnp.asarray(d),
                                 jnp.asarray(col), jnp.ones(N_PHOTONS, bool)),
                        lo, hi)
    return jpm, port_map(jpm)


def _wave_inputs(js, cfg, w=W, h=H):
    """Block-ordered wave-0 rays and bounce samples from the JAX
    Renderer (numpy)."""
    cam = JaxCamera(pos=TEST_CAMERA_POS, look_at=TEST_CAMERA_LOOK_AT)
    r = JaxRenderer(js, cam, cfg, w, h)
    idx = jnp.asarray(r.enum.index_image(0).ravel()[np.asarray(r._perm)])
    xr = r.sampler.sample(0, idx, r._index_bits).astype(jnp.float32)
    yr = r.sampler.sample(1, idx, r._index_bits).astype(jnp.float32)
    ro, rd = primary_rays(cam, w, h, xr * r.enum.scale_x,
                          yr * r.enum.scale_y)
    sx, sy = r._bounce_samples(idx)
    return [np.array(a) for a in (ro, rd, sx, sy)]


# each case compiles the JAX megakernel anew (15-30 s on a CPU), so the
# depth x map grid is cut to the three cases that cover both axes
@pytest.mark.parametrize("depth,with_map", [(4, False), (4, True), (8, True)],
                         ids=["d4-nomap", "d4-map", "d8-map"])
def test_mega_plain_matches_jax_megakernel(scenes, photon_maps, depth,
                                           with_map):
    js, ts = scenes
    jcfg = JaxConfig(min_samples=1, max_samples=1, max_depth=depth,
                     adaptive=False, dtype="float32", knn_backend="jnp")
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg)).replace(
        integrator="mega")
    assert routes.wave(ts, cfg) == ("k1", [])
    jpm, tpm = photon_maps if with_map else (None, None)
    ro, rd, sx, sy = _wave_inputs(js, jcfg)
    R = ro.shape[0]

    want, (nc_w, ns_w) = jax_mega(
        js, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(sx),
        jnp.asarray(sy), jnp.arange(R, dtype=jnp.uint32), wave_salt=0,
        photon_map=jpm, interpret=True)
    _cuda.reset_launches()
    got, (nc_g, ns_g) = dispatch_wave(
        ts, cfg, *[torch.from_numpy(a) for a in (ro, rd, sx, sy)], 0, tpm,
        lane_ids=torch.arange(R))
    assert _cuda.plain_calls["megakernel"] == 1
    want, got = np.asarray(want), got.numpy()
    assert np.isfinite(got).all()
    assert got.max() > 0.05                      # the wave sees light
    err = np.abs(got - want).max()
    assert err < 1e-4, f"max abs err {err}"
    assert int(nc_g) == int(nc_w), (int(nc_g), int(nc_w))
    assert int(ns_g) == int(ns_w), (int(ns_g), int(ns_w))


def test_mega_plain_matches_jax_megakernel_glass_box():
    """The 8,342-triangle glass box, 256 lanes, depth 4, no map: the scene
    whose feature table K1 walks from device memory, against the JAX
    kernel's ordered chunk walk."""
    js = jax_build(lambda b, mg: cornell_box(b, mg, True, GLASS_SUBDIVS))
    ts = port_scene(js)
    assert ts.n_tris == 8342
    assert chunk_boxes(ts).shape[1] == 66 > LINEAR_CHUNK_CAP
    jcfg = JaxConfig(min_samples=1, max_samples=1, max_depth=4,
                     adaptive=False, dtype="float32", knn_backend="jnp")
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg)).replace(
        integrator="mega")
    assert routes.wave(ts, cfg) == ("k1", [])
    ro, rd, sx, sy = _wave_inputs(js, jcfg, 16, 16)
    R = ro.shape[0]
    want, (nc_w, ns_w) = jax_mega(
        js, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(sx),
        jnp.asarray(sy), jnp.arange(R, dtype=jnp.uint32), wave_salt=0,
        interpret=True)
    got, (nc_g, ns_g) = dispatch_wave(
        ts, cfg, *[torch.from_numpy(a) for a in (ro, rd, sx, sy)],
        lane_ids=torch.arange(R))
    want, got = np.asarray(want), got.numpy()
    assert np.isfinite(got).all() and got.max() > 0.05
    err = np.abs(got - want).max()
    assert err < 1e-4, f"max abs err {err}"
    assert int(nc_g) == int(nc_w), (int(nc_g), int(nc_w))
    assert int(ns_g) == int(ns_w), (int(ns_g), int(ns_w))
