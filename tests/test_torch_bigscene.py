"""The big-scene path end to end at tiny size: the port's staged wave on a
scene past 16,384 triangles (every closest and any-hit query through the
superchunk trace's plain walk) against the JAX staged ``radiance_wave`` on
its Pallas backend (``_stream_trace`` in interpret mode), with the
tolerance of tests/test_torch_render.py; and the staged wave's plain-call
accounting.

The JAX wave runs eagerly (``jax.disable_jit``), as the port does.  Under
``jit`` the wave's bounce scan fuses its float arithmetic, which moves the
last bits of a shading point; on this finely tessellated sphere that flips
one shadow ray at a triangle edge in 256 lanes (ROADMAP C.3).  Eager, every
lane agrees to below 1e-6."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.render import Camera as JaxCamera
from gi_raytracer_tpu.render.camera import primary_rays
from gi_raytracer_tpu.render.integrator import (
    Renderer as JaxRenderer, radiance_wave as jax_radiance_wave)
from gi_raytracer_tpu.render.photon import (PhotonBatch as JaxBatch,
                                            build_photon_map as jax_build_map)
from gi_raytracer_tpu_torch import convert
from gi_raytracer_tpu_torch.ops import _cuda
from gi_raytracer_tpu_torch.render.integrator import (dispatch_wave,
                                                      radiance_wave)
from gi_raytracer_tpu_torch.scene.cornell import cornell_box

from _torch_parity import (jax_build, port_map, port_scene,
                           random_photon_batch, TEST_CAMERA_POS,
                           TEST_CAMERA_LOOK_AT)

W = H = 16          # 256 lanes, one tile
GLASS_SUBDIVS = 6   # 32,768 sphere triangles, 32,918 in all


@pytest.fixture(scope="module")
def scenes():
    js = jax_build(lambda b, mg: cornell_box(b, mg, True, GLASS_SUBDIVS))
    ts = port_scene(js)
    assert ts.n_tris == 32_918
    return js, ts


def _wave_inputs(js, cfg):
    """Block-ordered wave-0 rays and bounce samples from the JAX Renderer."""
    cam = JaxCamera(pos=TEST_CAMERA_POS, look_at=TEST_CAMERA_LOOK_AT)
    r = JaxRenderer(js, cam, cfg, W, H)
    idx = jnp.asarray(r.enum.index_image(0).ravel()[np.asarray(r._perm)])
    xr = r.sampler.sample(0, idx, r._index_bits).astype(jnp.float32)
    yr = r.sampler.sample(1, idx, r._index_bits).astype(jnp.float32)
    ro, rd = primary_rays(cam, W, H, xr * r.enum.scale_x,
                          yr * r.enum.scale_y)
    sx, sy = r._bounce_samples(idx)
    return [np.array(a) for a in (ro, rd, sx, sy)]


def test_staged_big_scene_wave_matches_jax(scenes):
    js, ts = scenes
    jcfg = JaxConfig(min_samples=1, max_samples=1, max_depth=3,
                     adaptive=False, intersect_backend="pallas",
                     integrator="staged", knn_backend="jnp")
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(1)
    lo = np.asarray(js.world_min, np.float32)
    hi = np.asarray(js.world_max, np.float32)
    pos, d, col = random_photon_batch(rng, 3000, lo, hi)
    jpm = jax_build_map(JaxBatch(jnp.asarray(pos), jnp.asarray(d),
                                 jnp.asarray(col), jnp.ones(3000, bool)),
                        lo, hi)
    tpm = port_map(jpm)
    ro, rd, sx, sy = _wave_inputs(js, jcfg)
    R = ro.shape[0]
    with jax.disable_jit():
        want, (nc_w, ns_w) = jax_radiance_wave(
            js, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(sx),
            jnp.asarray(sy), jax.random.PRNGKey(0), photon_map=jpm,
            with_counts=True, lane_ids=jnp.arange(R, dtype=jnp.uint32))
    _cuda.reset_launches()
    got, (nc_g, ns_g) = radiance_wave(
        ts, cfg, *[torch.from_numpy(a) for a in (ro, rd, sx, sy)], 0, tpm,
        lane_ids=torch.arange(R))
    # every trace went through the superchunk walk (plain, on the CPU),
    # and the staged wave is this scene's path, not K1's stand-in
    assert _cuda.plain_calls["stream"] == 2 * jcfg.max_depth
    assert _cuda.plain_calls["intersect"] == 0
    assert _cuda.plain_calls["megakernel"] == 0
    want, got = np.asarray(want), got.numpy()
    assert np.isfinite(got).all() and got.max() > 0.05
    close = (np.abs(got - want) <= 1e-4).all(-1)
    assert close.mean() >= 0.999, close.mean()
    assert int(nc_g) == int(nc_w) and int(ns_g) == int(ns_w)


def test_staged_wave_counts_k1_plain_only_where_k1_runs(scenes):
    """A mega-eligible scene's staged wave is K1's plain version (counted);
    past MEGA_TRI_CAP it is the path (not counted).  Which route each
    takes is tests/test_torch_routes.py's ("cornell_small",
    "glass_32918")."""
    _, big = scenes
    small = cornell_box(*_port_builders(), False).build(device="cpu")
    cfg = convert.config_from_dict(dict(
        dataclasses.asdict(JaxConfig()), max_depth=1, adaptive=False))
    ro = torch.tensor([[-0.4, 0.3, -3.8]]).expand(8, 3).contiguous()
    rd = torch.tensor([[0.0, 0.0, 1.0]]).expand(8, 3).contiguous()
    sx = sy = torch.full((1, 8), 0.5)
    for scene, counted in ((small, 1), (big, 0)):
        _cuda.reset_launches()
        dispatch_wave(scene, cfg, ro, rd, sx, sy)
        assert _cuda.plain_calls["megakernel"] == counted
    _cuda.reset_launches()
    radiance_wave(big, cfg, ro, rd, sx, sy, plain=True)
    assert _cuda.plain_calls["megakernel"] == 1


def _port_builders():
    from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
    return SceneBuilder, meshgen
