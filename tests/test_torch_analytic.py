"""Port parity for analytic spheres and cones: the ray tests, the traces
with their sphere and cone passes layered over the triangle query, the
sphere and cone shade rows and hit attributes, the builder's light cones
and world bounds, and one staged wave of the analytic Cornell box, against
the JAX package on the same arrays.

The JAX side runs its CPU route (the BVH walk plus its dense sphere and
cone passes); the port runs the dense trace's plain walk (K2's CPU side)
plus its passes.  Tolerances: t, normals and uvs 1e-6 (relative to the
value past 1, since float32 spacing at t ~ 10 is 1e-6), prims equal; the
staged wave as tests/test_torch_bigscene.py holds it (1e-4 on >= 99.9% of
lanes, equal ray counts), run eagerly on the JAX side."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.ops import intersect as ji
from gi_raytracer_tpu.render import shading as jsh
from gi_raytracer_tpu.render import Camera as JaxCamera
from gi_raytracer_tpu.render.camera import primary_rays
from gi_raytracer_tpu.render.integrator import (
    Renderer as JaxRenderer, radiance_wave as jax_radiance_wave)
from gi_raytracer_tpu.render.photon import (PhotonBatch as JaxBatch,
                                            build_photon_map as jax_build_map)
from gi_raytracer_tpu_torch import convert
from gi_raytracer_tpu_torch.ops import intersect as ti
from gi_raytracer_tpu_torch.ops import prim_rows
from gi_raytracer_tpu_torch.render import shading as tsh
from gi_raytracer_tpu_torch.render.integrator import radiance_wave
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
from gi_raytracer_tpu_torch.scene.cornell import ANALYTIC_TRIS, cornell_box

from _torch_parity import (assert_scene_arrays_equal, jax_build, port_map,
                           port_scene, random_photon_batch, to_numpy,
                           TEST_CAMERA_POS, TEST_CAMERA_LOOK_AT)

TOL = 1e-6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _populate(builder, mg):
    """Random triangles, spheres and cones; opaque, half-opaque (the
    stochastic accept) and refractive materials; one light."""
    rng = np.random.default_rng(11)
    b = builder()
    t0 = b.add_texture_const((0.7, 0.7, 0.7))
    t1 = b.add_texture_checker(4, (0.9, 0.2, 0.2), (0.2, 0.9, 0.2))
    blk = b.add_texture_const((0.0, 0.0, 0.0))
    mats = [b.add_material(t0, blk, 1.0, 1.0, 1.0),
            b.add_material(t1, blk, 0.05, 0.5, 1.0),
            b.add_material(t0, blk, 0.0, 0.0, 1.5)]
    centers = rng.uniform(-5, 5, (60, 3))
    tris = centers[:, None, :] + rng.uniform(-0.9, 0.9, (60, 3, 3))
    b.add_triangles(tris, None, None, mats[0])
    for i in range(6):
        b.add_sphere(tuple(rng.uniform(-4, 4, 3)),
                     float(rng.uniform(0.3, 1.2)), mats[i % 3])
    for i in range(5):
        b.add_cone(tuple(rng.uniform(-4, 4, 3)),
                   tuple(rng.uniform(-np.pi, np.pi, 3)),
                   float(rng.uniform(0.4, 1.0)), float(rng.uniform(0.8, 2.0)),
                   mats[(i + 1) % 3])
    b.add_light((0.0, 6.0, 0.0), (5.0, 5.0, 5.0), 0.4)
    return b


@pytest.fixture(scope="module")
def mixed():
    js = jax_build(_populate)
    rng = np.random.default_rng(5)
    R = 1500
    ro = rng.uniform(-8, 8, (R, 3)).astype(np.float32)
    # aim most rays at the analytic prims so they are hit often
    tgt = np.concatenate([np.asarray(js.spheres.pos),
                          np.asarray(js.cones.pos)])[rng.integers(0, 11, R)]
    rd = (tgt + rng.normal(scale=0.6, size=(R, 3)) - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return js, port_scene(js), ro, rd


def test_builders_agree_with_spheres_cones_and_light_cones():
    """Both builders emit the same arrays: spheres, cones (their world->
    local rotations), the world bounds over all three kinds (which moves
    the photon grid) and the light cone toward specular triangles and
    spheres (cones do not count)."""
    js = jax_build(_populate)
    ts = _populate(SceneBuilder, meshgen).build(device="cpu")
    assert (ts.n_tris, ts.n_spheres, ts.n_cones) == (60, 6, 5)
    assert_scene_arrays_equal(ts, js)
    assert ts.all_opaque == js.all_opaque is False
    # spheres and cones reach past the triangles' bounds
    tri_v = ts.tris.v0.numpy()
    assert (ts.world_min.numpy() < tri_v.min(0) - 1e-3).any()
    assert float(ts.lights.angle[0]) > 0.0


def test_ray_sphere_cone_and_cone_attrs(mixed):
    js, ts, ro, rd = mixed
    sp, cn = js.spheres, js.cones
    want_t, want_ok = ji.ray_sphere(jnp.asarray(ro)[:, None, :],
                                    jnp.asarray(rd)[:, None, :],
                                    sp.pos[None], sp.rad[None])
    got_t, got_ok = ti.ray_sphere(_t(ro)[:, None, :], _t(rd)[:, None, :],
                                  ts.spheres.pos[None], ts.spheres.rad[None])
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert np.asarray(want_ok).sum() > 300
    _close(got_t, want_t)

    want_t, want_ok = ji.ray_cone(jnp.asarray(ro)[:, None, :],
                                  jnp.asarray(rd)[:, None, :], cn.pos[None],
                                  cn.rad[None], cn.height[None], cn.w2l[None])
    tc = ts.cones
    got_t, got_ok = ti.ray_cone(_t(ro)[:, None, :], _t(rd)[:, None, :],
                                tc.pos[None], tc.rad[None], tc.height[None],
                                tc.w2l[None])
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert np.asarray(want_ok).sum() > 300
    _close(got_t, want_t)

    # attributes at the nearest cone hit of every lane that hits one, in
    # float64: XLA contracts the gathered rotations' dot products into
    # FMAs, and the normal's cross product magnifies that last bit
    wt, wok = np.asarray(want_t), np.asarray(want_ok)
    lanes = np.nonzero(wok.any(1))[0]
    cid = np.argmin(wt[lanes], 1).astype(np.int32)
    pt = ro[lanes] + wt[lanes, cid][:, None].astype(np.float64) * rd[lanes]
    cn64 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a, cn)
    tc64 = dataclasses.replace(tc, pos=tc.pos.double(), rad=tc.rad.double(),
                               height=tc.height.double(), w2l=tc.w2l.double())
    wn, wuv = ji.cone_attrs(cn64, jnp.asarray(pt), jnp.asarray(cid))
    gn, guv = ti.cone_attrs(tc64, _t(pt), _t(cid))
    assert gn.dtype == torch.float64
    _close(gn, wn)
    _close(guv, wuv)


def test_trace_closest_and_any_with_analytic_passes(mixed):
    js, ts, ro, rd = mixed
    R = ro.shape[0]
    rid = np.random.default_rng(2).integers(0, 2**32, R, dtype=np.uint64)
    act = np.random.default_rng(3).uniform(size=R) < 0.9
    lim = np.random.default_rng(4).uniform(1, 12, R).astype(np.float32)
    for salt in (0, 12345):
        want = ji.trace_closest(js, jnp.asarray(ro), jnp.asarray(rd),
                                salt=salt, active=jnp.asarray(act),
                                ray_id=jnp.asarray(rid.astype(np.uint32)))
        got = ti.trace_closest(ts, _t(ro), _t(rd), salt=salt,
                               active=_t(act), ray_id=_t(rid.astype(np.int64)))
        wp = np.asarray(want.prim)
        assert np.array_equal(got.prim.numpy(), wp)
        kinds = np.bincount(np.searchsorted([0, 60, 66], wp[wp >= 0],
                                            side="right"), minlength=4)
        assert kinds[1:].min() > 20, kinds       # every kind wins lanes
        hit = wp >= 0
        _close(got.t.numpy()[hit], np.asarray(want.t)[hit])
        _close(got.u.numpy()[hit], np.asarray(want.u)[hit])
        _close(got.v.numpy()[hit], np.asarray(want.v)[hit])

        want_o = ji.trace_any(js, jnp.asarray(ro), jnp.asarray(rd),
                              jnp.asarray(lim), salt=salt,
                              active=jnp.asarray(act),
                              ray_id=jnp.asarray(rid.astype(np.uint32)))
        got_o = ti.trace_any(ts, _t(ro), _t(rd), _t(lim), salt=salt,
                             active=_t(act), ray_id=_t(rid.astype(np.int64)))
        assert np.array_equal(got_o.numpy(), np.asarray(want_o))
        assert 0.1 < np.asarray(want_o).mean() < 0.9


def test_trace_closest_rows_swaps_in_the_analytic_row(mixed):
    """The JAX Pallas route's trace_closest_rows (interpret mode): where a
    sphere or cone wins, its shade row replaces the triangle's."""
    js, ts, ro, rd = mixed
    R = 512
    ro, rd = ro[:R], rd[:R]
    lim = np.full(R, 9.0, np.float32)
    want, wrow = ji.trace_closest_rows(
        js, jsh.build_prim_rows(js), jnp.asarray(ro), jnp.asarray(rd),
        t_max=jnp.asarray(lim), salt=7, backend="pallas")
    got, grow = ti.trace_closest_rows(ts, prim_rows.build_prim_rows(ts), _t(ro),
                                      _t(rd), t_max=_t(lim), salt=7)
    wp = np.asarray(want.prim)
    assert np.array_equal(got.prim.numpy(), wp)
    assert (wp >= 60).sum() > 50 and (wp >= 66).sum() > 10
    hit = wp >= 0
    _close(got.t.numpy()[hit], np.asarray(want.t)[hit])
    _close(grow.numpy(), np.asarray(wrow))


def test_sphere_cone_shade_rows_and_attributes():
    """In float64 (the cone normal, as in the test above)."""
    import gi_raytracer_tpu.scene.build as jb
    from gi_raytracer_tpu.scene import meshgen as jmeshgen

    js = _populate(jb.SceneBuilder, jmeshgen).build(dtype=np.float64)
    ts = convert.scene_from_arrays(
        convert.scene_to_arrays(to_numpy(js)), all_opaque=js.all_opaque,
        has_image_tex=js.has_image_tex, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(5)
    ro = rng.uniform(-8, 8, (1500, 3))
    tgt = np.concatenate([np.asarray(js.spheres.pos),
                          np.asarray(js.cones.pos)])[rng.integers(0, 11, 1500)]
    rd = tgt + rng.normal(scale=0.6, size=(1500, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    jrows = np.asarray(jsh.build_prim_rows(js))
    trows = prim_rows.build_prim_rows(ts)
    assert trows.shape == jrows.shape == (71, 64)
    _close(trows.numpy(), jrows, 0)
    h = ji.trace_closest(js, jnp.asarray(ro), jnp.asarray(rd))
    t, prim, u, v = (np.asarray(x) for x in h)
    assert (prim >= 66).sum() > 50
    want = jsh.shade_from_rows(js, jnp.asarray(jrows[np.clip(prim, 0, 70)]),
                               jnp.asarray(ro), jnp.asarray(rd), *h)
    got = tsh.shade_from_rows(ts, trows[_t(np.clip(prim, 0, 70)).long()],
                              _t(ro), _t(rd), _t(t), _t(prim), _t(u), _t(v))
    for name in ("point", "normal", "uv", "color", "emissive", "alpha",
                 "rough", "ior"):
        _close(getattr(got, name), getattr(want, name))
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))

    wa = jsh.hit_attributes_uv(js, jnp.asarray(ro), jnp.asarray(rd), *h)
    ga = tsh.hit_attributes_uv(ts, _t(ro), _t(rd), _t(t), _t(prim), _t(u),
                               _t(v))
    for name in ("point", "normal", "uv"):
        _close(getattr(ga, name), getattr(wa, name))
    assert np.array_equal(ga.mat_id.numpy(), np.asarray(wa.mat_id))
    wm = jsh.material_lookup(js, wa.mat_id, wa.uv)
    gm = tsh.material_lookup(ts, ga.mat_id, ga.uv)
    for g, w in zip(gm, wm):
        _close(g, w)


@pytest.fixture(scope="module")
def cornell():
    js = jax_build(lambda b, mg: cornell_box(b, mg, False, analytic=True))
    ts = port_scene(js)
    assert (ts.n_tris, ts.n_spheres, ts.n_cones) == (ANALYTIC_TRIS, 2, 1)
    assert ts.has_image_tex
    return js, ts


def test_analytic_cornell_builds_the_same_in_both_packages(cornell):
    js, _ = cornell
    ts = cornell_box(SceneBuilder, meshgen, False, analytic=True).build(
        device="cpu")
    assert_scene_arrays_equal(ts, js, atol=0)
    assert ts.textures.atlas.shape == (256 * 256, 4)


@pytest.mark.parametrize("with_map", [False, True], ids=["nomap", "map"])
def test_analytic_cornell_staged_wave_matches_jax(cornell, with_map):
    js, ts = cornell
    W = H = 16
    jcfg = JaxConfig(min_samples=1, max_samples=1, max_depth=4,
                     adaptive=False, integrator="staged", knn_backend="jnp")
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jpm = tpm = None
    if with_map:
        rng = np.random.default_rng(1)
        lo = np.asarray(js.world_min, np.float32)
        hi = np.asarray(js.world_max, np.float32)
        pos, d, col = random_photon_batch(rng, 3000, lo, hi)
        jpm = jax_build_map(JaxBatch(jnp.asarray(pos), jnp.asarray(d),
                                     jnp.asarray(col), jnp.ones(3000, bool)),
                            lo, hi)
        tpm = port_map(jpm)
    cam = JaxCamera(pos=TEST_CAMERA_POS, look_at=TEST_CAMERA_LOOK_AT)
    r = JaxRenderer(js, cam, jcfg, W, H)
    idx = jnp.asarray(r.enum.index_image(0).ravel()[np.asarray(r._perm)])
    xr = r.sampler.sample(0, idx, r._index_bits).astype(jnp.float32)
    yr = r.sampler.sample(1, idx, r._index_bits).astype(jnp.float32)
    ro, rd = primary_rays(cam, W, H, xr * r.enum.scale_x,
                          yr * r.enum.scale_y)
    sx, sy = r._bounce_samples(idx)
    ro, rd, sx, sy = (np.array(a) for a in (ro, rd, sx, sy))
    R = ro.shape[0]
    with jax.disable_jit():
        want, (nc_w, ns_w) = jax_radiance_wave(
            js, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(sx),
            jnp.asarray(sy), jax.random.PRNGKey(0), photon_map=jpm,
            with_counts=True, lane_ids=jnp.arange(R, dtype=jnp.uint32))
    got, (nc_g, ns_g) = radiance_wave(
        ts, cfg, *[torch.from_numpy(a) for a in (ro, rd, sx, sy)], 0, tpm,
        lane_ids=torch.arange(R))
    want, got = np.asarray(want), got.numpy()
    assert np.isfinite(got).all() and got.max() > 0.05
    close = (np.abs(got - want) <= 1e-4).all(-1)
    assert close.mean() >= 0.999, close.mean()
    assert int(nc_g) == int(nc_w) and int(ns_g) == int(ns_w)
