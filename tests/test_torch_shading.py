"""Port parity: camera rays, packed prim rows, shading, secondary rays and
hit attributes against the JAX package (<= 1e-5 abs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu.render import camera as jcam
from gi_raytracer_tpu.render import shading as jsh
from gi_raytracer_tpu.ops.intersect import closest_hit as jax_closest_hit
from gi_raytracer_tpu_torch import convert
from gi_raytracer_tpu_torch.ops import prim_rows
from gi_raytracer_tpu_torch.render import camera as tcam
from gi_raytracer_tpu_torch.render import shading as tsh
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen

from _torch_parity import (jax_build, jax_cornell, port_scene, to_numpy,
                           TEST_CAMERA_POS, TEST_CAMERA_LOOK_AT)

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def scenes():
    js = jax_cornell(False)
    return js, port_scene(js)


@pytest.fixture(scope="module")
def hits(scenes):
    """Primary rays of the test camera and their JAX closest hits."""
    js, _ = scenes
    rng = np.random.default_rng(0)
    W = H = 24
    dx = rng.uniform(0, W, 2048).astype(np.float32)
    dy = rng.uniform(0, H, 2048).astype(np.float32)
    cam = jcam.Camera(pos=TEST_CAMERA_POS, look_at=TEST_CAMERA_LOOK_AT)
    ro, rd = jcam.primary_rays(cam, W, H, jnp.asarray(dx), jnp.asarray(dy))
    h = jax_closest_hit(js, ro, rd)
    return (np.array(ro), np.array(rd), np.array(h.t, np.float32),
            np.array(h.prim), np.array(h.u, np.float32),
            np.array(h.v, np.float32))


def test_primary_rays():
    rng = np.random.default_rng(1)
    W, H = 40, 30
    dx = rng.uniform(0, W, 1000).astype(np.float32)
    dy = rng.uniform(0, H, 1000).astype(np.float32)
    for pos, look in ((TEST_CAMERA_POS, TEST_CAMERA_LOOK_AT),
                      ((0.0, 0.0, -14.0), (0.0, 0.0, 0.0)),
                      ((10.0, 5.0, 0.0), (0.0, 1.0, 0.0))):
        jro, jrd = jcam.primary_rays(jcam.Camera(pos=pos, look_at=look), W, H,
                                     jnp.asarray(dx), jnp.asarray(dy))
        tro, trd = tcam.primary_rays(tcam.Camera(pos=pos, look_at=look), W, H,
                                     torch.from_numpy(dx), torch.from_numpy(dy))
        _close(tro, jro)
        _close(trd, jrd)


def test_build_prim_rows(scenes):
    js, ts = scenes
    want = np.asarray(jsh.build_prim_rows(js))
    got = prim_rows.build_prim_rows(ts).numpy()
    assert got.shape == want.shape == (ts.n_tris, prim_rows.PR_W)
    _close(got, want, atol=0.0)


def test_hit_attributes_and_material(scenes, hits):
    js, ts = scenes
    ro, rd, t, prim, u, v = hits
    assert (prim >= 0).mean() > 0.9
    ja = jsh.hit_attributes_uv(js, ro, rd, t, prim, u, v)
    tt = [torch.from_numpy(x) for x in (ro, rd, t, prim, u, v)]
    ta = tsh.hit_attributes_uv(ts, *tt)
    for name in ("point", "normal", "uv"):
        _close(getattr(ta, name), getattr(ja, name))
    assert np.array_equal(ta.mat_id.numpy(), np.asarray(ja.mat_id))
    assert np.array_equal(ta.valid.numpy(), np.asarray(ja.valid))
    jm = jsh.material_lookup(js, ja.mat_id, ja.uv)
    tm = tsh.material_lookup(ts, ta.mat_id, ta.uv)
    for g, w in zip(tm, jm):
        _close(g, w)


def test_shade_from_rows(scenes, hits):
    js, ts = scenes
    ro, rd, t, prim, u, v = hits
    jrows = jsh.build_prim_rows(js)
    jrow = jrows[np.clip(prim, 0, js.n_tris - 1)]
    want = jsh.shade_from_rows(js, jrow, ro, rd, t, prim, u, v)
    trow = prim_rows.build_prim_rows(ts)[torch.from_numpy(
        np.clip(prim, 0, js.n_tris - 1)).long()]
    got = tsh.shade_from_rows(ts, trow, *[torch.from_numpy(x) for x in
                                          (ro, rd, t, prim, u, v)])
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name == "valid":
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)


def _checker_ball(builder, mg):
    b = builder()
    chk = b.add_texture_checker(8, (0.9, 0.1, 0.1), (0.1, 0.1, 0.9))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    v, n, uv = mg.sphere_mesh((0.0, 0.0, 0.0), 1.0, 2)
    b.add_triangles(v, n, uv, mat_id=b.add_material(chk, black, 1.0, 1.0))
    b.add_light((0.0, 3.0, 0.0), (8.0, 8.0, 8.0), 0.3)
    return b


def test_checker_texture_matches_jax():
    """A checker-textured sphere mesh: the builders agree array by array,
    and the shade rows give the JAX colours, both checker colours seen."""
    js = jax_build(_checker_ball)
    ts = _checker_ball(SceneBuilder, meshgen).build(device="cpu")
    want_arrays = convert.scene_to_arrays(to_numpy(js))
    for k, g in convert.scene_to_arrays(ts).items():
        np.testing.assert_allclose(g, want_arrays[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    rng = np.random.default_rng(4)
    W = H = 24
    cam = jcam.Camera(pos=(0.0, 0.5, -4.0), look_at=(0.0, 0.0, 0.0))
    ro, rd = jcam.primary_rays(
        cam, W, H, jnp.asarray(rng.uniform(0, W, 2048), jnp.float32),
        jnp.asarray(rng.uniform(0, H, 2048), jnp.float32))
    h = jax_closest_hit(js, ro, rd)
    ro, rd = np.array(ro), np.array(rd)
    t, prim = np.array(h.t, np.float32), np.array(h.prim)
    u, v = np.array(h.u, np.float32), np.array(h.v, np.float32)
    p = np.clip(prim, 0, js.n_tris - 1)
    want = jsh.shade_from_rows(js, jsh.build_prim_rows(js)[p], ro, rd, t,
                               prim, u, v)
    got = tsh.shade_from_rows(
        ts, prim_rows.build_prim_rows(ts)[torch.from_numpy(p).long()],
        *[torch.from_numpy(x) for x in (ro, rd, t, prim, u, v)])
    _close(got.color, want.color)
    _close(got.uv, want.uv)
    red = got.color[:, 0] > 0.5
    hit = torch.from_numpy(prim >= 0)
    assert red[hit].any() and (~red[hit]).any()


def test_secondary_ray():
    rng = np.random.default_rng(2)
    R = 4096
    f32 = np.float32

    def unit(n):
        x = rng.normal(size=(n, 3))
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(f32)

    rd, normal = unit(R), unit(R)
    color = rng.uniform(0, 1, (R, 3)).astype(f32)
    contrib = rng.uniform(0, 1, (R, 3)).astype(f32)
    # every branch: diffuse, glossy, mirror, refractive, translucent
    rough = rng.choice(np.array([1.0, 0.5, 0.0, 0.0005, 0.95], f32), R)
    ior = rng.choice(np.array([1.0, 1.5, 1.33], f32), R)
    alpha = rng.choice(np.array([1.0, 0.0, 0.5], f32), R)
    sx, sy, uo, uf = (rng.uniform(0, 1, R).astype(f32) for _ in range(4))
    args = (rd, normal, color, alpha, rough, ior, sx, sy, uo, uf, contrib)
    want = jsh.secondary_ray(*[jnp.asarray(a) for a in args])
    got = tsh.secondary_ray(*[torch.from_numpy(a) for a in args])
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name))
