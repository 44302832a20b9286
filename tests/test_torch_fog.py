"""Port parity for height fog: the noise grid (bit for bit), the density,
the box overlap, the march (the port's blocked march and its step-by-step
plain version), shadow-ray occlusion and the in-scattering override, all
keyed on global lane ids, and one staged fog wave, against the JAX
package's ``render.atmosphere`` on the scene of tests/test_atmosphere.py.

Tolerances: scatter flags equal, t and densities 1e-6 (relative past 1);
the staged wave as tests/test_torch_bigscene.py holds it (1e-4 on >= 99.9%
of lanes, equal ray counts).  The JAX wave runs under its own bounce scan
(eager, its 512-step march loops take minutes on a CPU)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.render import atmosphere as ja
from gi_raytracer_tpu.render import Camera as JaxCamera
from gi_raytracer_tpu.render.camera import primary_rays
from gi_raytracer_tpu.render.integrator import (
    Renderer as JaxRenderer, radiance_wave as jax_radiance_wave)
from gi_raytracer_tpu_torch import convert
from gi_raytracer_tpu_torch.render import atmosphere as ta
from gi_raytracer_tpu_torch.render.integrator import radiance_wave
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen

from _torch_parity import assert_scene_arrays_equal, jax_build, port_scene

TOL = 1e-6
CAM = ((0.0, 1.0, -12.0), (0.0, 0.0, 0.0))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _foggy(builder, mg, density=1.0, seed=0):
    """tests/test_atmosphere.py's ``_foggy_scene``: a floor quad under a
    fog box, one light."""
    b = builder()
    white = b.add_texture_const((0.9, 0.9, 0.9))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    m = b.add_material(white, black, 1.0, 1.0, 1.0)
    b.add_triangles(mg.quad_mesh((-20, -2, -20), (20, -2, -20), (-20, -2, 20),
                                 (20, -2, 20)), mat_id=m)
    b.add_height_fog((0, 1, 0), (8, 4, 8), (0.8, 0.85, 0.9),
                     density, 1.0, 1.0, seed=seed)
    b.add_light((0.0, 8.0, 0.0), (30.0, 30.0, 30.0), 0.3)
    return b


@pytest.fixture(scope="module")
def scenes():
    js = jax_build(_foggy)
    return js, port_scene(js)


@pytest.fixture(scope="module")
def rays():
    """Rays from around the fog box through it, global lane ids past
    2^31, and a segment cap per ray."""
    rng = np.random.default_rng(4)
    R = 2000
    ro = rng.uniform(-7, 7, (R, 3)).astype(np.float32)
    tgt = rng.uniform(-3, 3, (R, 3)) + np.array([0.0, 1.0, 0.0])
    rd = (tgt - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rid = (np.uint64(3) << np.uint64(31)) + np.arange(R, dtype=np.uint64)
    cap = rng.uniform(0.5, 25.0, R).astype(np.float32)
    return ro, rd, rid, cap


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 3])
def test_noise_grid_bit_for_bit(seed):
    """The same generator, seed and grid shape in both builders."""
    js = jax_build(lambda b, mg: _foggy(b, mg, 2.5, seed))
    ts = _foggy(SceneBuilder, meshgen, 2.5, seed).build(device="cpu")
    assert ts.fog.grid.shape == (9, 5, 9)
    assert np.array_equal(ts.fog.grid.numpy(), np.asarray(js.fog.grid))
    assert_scene_arrays_equal(ts, js, atol=0)


def test_fog_density_and_bounds(scenes, rays):
    js, ts = scenes
    ro, rd, _, cap = rays
    p = np.random.default_rng(0).uniform(-5, 5, (4096, 3)).astype(np.float32)
    want = np.asarray(ja.fog_density(js, jnp.asarray(p)))
    got = ta.fog_density(ts, _t(p)).numpy()
    _close(got, want)
    assert (want > 0).mean() > 0.15 and (want == 0).mean() > 0.3
    assert np.array_equal(got == 0, want == 0)

    w = ja._fog_bounds(js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(cap))
    g = ta._fog_bounds(ts, _t(ro), _t(rd), _t(cap))
    assert np.array_equal(g[2].numpy(), np.asarray(w[2]))
    assert 0.3 < np.asarray(w[2]).mean() < 0.95
    _close(g[0], w[0])
    _close(g[1], w[1])


@pytest.mark.parametrize("march", ["blocked", "steps"])
def test_march_on_global_lane_ids(scenes, rays, march):
    js, ts = scenes
    ro, rd, rid, cap = rays
    jcfg = JaxConfig()
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    tmin, tmax, has = ja._fog_bounds(js, jnp.asarray(ro), jnp.asarray(rd),
                                     jnp.asarray(cap))
    salt = 0x9E3779B9
    wf, wt = ja._march(js, jcfg, jnp.asarray(ro), jnp.asarray(rd), tmin, tmax,
                       has, salt, ray_id=jnp.asarray(rid.astype(np.uint32)))
    fn = ta._march if march == "blocked" else ta._march_steps
    gf, gt = fn(ts, cfg, _t(ro), _t(rd), _t(tmin), _t(tmax), _t(has), salt,
                ray_id=_t(rid.astype(np.int64)))
    wf = np.asarray(wf)
    assert np.array_equal(gf.numpy(), wf)
    assert 0.2 < wf.mean() < 0.8, wf.mean()
    _close(gt.numpy()[wf], np.asarray(wt)[wf])


def test_fog_occludes_and_override(scenes, rays):
    js, ts = scenes
    ro, rd, rid, cap = rays
    R = ro.shape[0]
    jcfg = JaxConfig()
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jrid = jnp.asarray(rid.astype(np.uint32))
    trid = _t(rid.astype(np.int64))
    want = np.asarray(ja.fog_occludes(js, jcfg, jnp.asarray(ro),
                                      jnp.asarray(rd), jnp.asarray(cap),
                                      12345 + 104729, ray_id=jrid))
    got = ta.fog_occludes(ts, cfg, _t(ro), _t(rd), _t(cap), 12345 + 104729,
                          ray_id=trid).numpy()
    assert np.array_equal(got, want) and 0.1 < want.mean() < 0.9

    rng = np.random.default_rng(9)
    t_surf = cap.copy()
    t_surf[::7] = np.inf                         # misses march nothing
    sx, sy = (rng.uniform(size=R).astype(np.float32) for _ in range(2))
    vec = [rng.normal(size=(R, 3)).astype(np.float32) for _ in range(6)]
    rough = rng.uniform(size=R).astype(np.float32)
    sign = np.where(rng.uniform(size=R) < 0.5, -1.0, 1.0).astype(np.float32)
    args = (sx, sy, 777, *vec[:3], vec[3], vec[4], vec[5], rough, sign)
    w = ja.fog_override(js, jcfg, jnp.asarray(ro), jnp.asarray(rd),
                        jnp.asarray(t_surf),
                        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                          for a in args], ray_id=jrid)
    g = ta.fog_override(ts, cfg, _t(ro), _t(rd), _t(t_surf),
                        *[_t(a) if isinstance(a, np.ndarray) else a
                          for a in args], ray_id=trid)
    scat = np.asarray(w[6]) != rough
    assert 0.1 < scat.mean() < 0.9 and not scat[::7].any()
    assert np.array_equal(g[6].numpy() != rough, scat)
    for gi, wi in zip(g, w):
        _close(gi, wi)


def test_fog_staged_wave_matches_jax(scenes):
    """One staged wave of the fog scene (16x16, depth 3), every bounce
    marching the fog and every shadow ray through it."""
    js, ts = scenes
    W = H = 16
    jcfg = JaxConfig(min_samples=1, max_samples=1, max_depth=3,
                     adaptive=False, integrator="staged", knn_backend="jnp")
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    cam = JaxCamera(pos=CAM[0], look_at=CAM[1])
    r = JaxRenderer(js, cam, jcfg, W, H)
    idx = jnp.asarray(r.enum.index_image(0).ravel()[np.asarray(r._perm)])
    xr = r.sampler.sample(0, idx, r._index_bits).astype(jnp.float32)
    yr = r.sampler.sample(1, idx, r._index_bits).astype(jnp.float32)
    ro, rd = primary_rays(cam, W, H, xr * r.enum.scale_x,
                          yr * r.enum.scale_y)
    sx, sy = r._bounce_samples(idx)
    ro, rd, sx, sy = (np.array(a) for a in (ro, rd, sx, sy))
    R = ro.shape[0]
    lane = 5 * R + np.arange(R)                  # wave 5's lane ids
    want, (nc_w, ns_w) = jax_radiance_wave(
        js, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(sx),
        jnp.asarray(sy), jax.random.PRNGKey(0), with_counts=True,
        lane_ids=jnp.asarray(lane, jnp.uint32))
    got, (nc_g, ns_g) = radiance_wave(
        ts, cfg, *[torch.from_numpy(a) for a in (ro, rd, sx, sy)], 0,
        lane_ids=torch.from_numpy(lane))
    want, got = np.asarray(want), got.numpy()
    assert np.isfinite(got).all() and got.max() > 0.05
    close = (np.abs(got - want) <= 1e-4).all(-1)
    assert close.mean() >= 0.999, close.mean()
    assert int(nc_g) == int(nc_w) and int(ns_g) == int(ns_w)
