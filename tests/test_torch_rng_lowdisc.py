"""The port's threefry streams, low-discrepancy samplers, Halton scrambles
and enumeration, and ``render_image`` against the JAX package on the CPU.

Threefry draws are bit-equal to ``jax.random`` (pinned here:
``jax_threefry_partitionable`` on, 64-bit seeds under ``jax_enable_x64``,
which ``tests/conftest.py`` sets).  With them, the port's default photon
pass gives the JAX package's batch slot for slot, and bounce dims past
Halton's 256 (depth > 127) draw the JAX renderer's samples."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.render import Camera as JaxCamera
from gi_raytracer_tpu.render.integrator import Renderer as JaxRenderer
from gi_raytracer_tpu.render.integrator import \
    render_image as jax_render_image
from gi_raytracer_tpu.render.photon import trace_photons as jax_trace
from gi_raytracer_tpu.sampling import halton as jh
from gi_raytracer_tpu.sampling import lowdisc as jl
from gi_raytracer_tpu_torch import convert, entry
from gi_raytracer_tpu_torch.render import Camera, Renderer
from gi_raytracer_tpu_torch.render.integrator import render_image
from gi_raytracer_tpu_torch.render.photon import trace_photons
from gi_raytracer_tpu_torch.sampling.rng import ThreefryUniform
from gi_raytracer_tpu_torch.sampling import halton as th
from gi_raytracer_tpu_torch.sampling import lowdisc as tl
from gi_raytracer_tpu_torch.sampling import rng

from _torch_parity import (TEST_CAMERA_LOOK_AT, TEST_CAMERA_POS, jax_build,
                           jax_cornell, jax_uniform, port_scene)

GOLDEN = "tests/golden/halton_golden.npz"
SEEDS = [0, 1, 2**31 + 5, 2**40 + 123]


@pytest.fixture(autouse=True)
def pinned_layout():
    """The bit layout the port reproduces: fail, do not compare another."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_enable_x64


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_bit_equal(seed):
    k = jax.random.PRNGKey(seed)
    assert rng.PRNGKey(seed) == _key(k)
    for data in (0, 1, 8, 123456789, 0xFFFFFFFF):
        assert rng.fold_in(rng.PRNGKey(seed), data) == \
            _key(jax.random.fold_in(k, data))
    want = k
    for i in (3, 10, 7):
        want = jax.random.fold_in(want, i)
    assert rng.stream(rng.PRNGKey(seed), 3, 10, 7) == _key(want)


@pytest.mark.parametrize("shape", [(1,), (7,), (2, 5), (4, 33), (3, 2, 9)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_bit_equal(shape, dtype):
    for seed in SEEDS[:3]:
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        want = np.asarray(jax.random.uniform(k, shape, getattr(jnp, dtype)))
        got = rng.uniform(_key(k), shape, getattr(torch, dtype)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def test_default_trace_photons_matches_jax():
    """512 slots of the tiny scene, no hook: the stored mask is JAX's, the
    colours equal (rtol 1e-6), and the batch is bit-equal to the port's
    pass with JAX's own draws replayed through the ``uniform`` hook.
    Positions and directions leave the light through sin/cos/acos, whose
    last bits differ between XLA's CPU code and torch's; the glass
    sphere's two refractions magnify that to at most 3.9e-4 in position
    (scene units, the box is 8 wide) and 1.3e-6 in direction on this
    scene, so they are held to 1e-3 and 1e-5."""
    js = ge._tiny_scene(np.float32)
    ts = port_scene(js)
    jcfg = JaxConfig(photons=512, photon_retries=8, ray_chunk=64)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    want = jax_trace(js, jcfg)
    got = trace_photons(ts, cfg)
    replay = trace_photons(ts, cfg, uniform=jax_uniform(cfg.seed))
    for a, b in zip(got, replay):
        assert torch.equal(a, b)
    ws = np.asarray(want.stored)
    assert ws.mean() > 0.9
    assert np.array_equal(got.stored.numpy(), ws)
    np.testing.assert_allclose(got.col.numpy()[ws], np.asarray(want.col)[ws],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.dir.numpy()[ws], np.asarray(want.dir)[ws],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.pos.numpy()[ws], np.asarray(want.pos)[ws],
                               rtol=0, atol=1e-3)


def test_float64_emission_draws_64_bits():
    """A float64 scene draws float64 uniforms (64 random bits each, as
    ``jax.random.uniform(key, shape, float64)``), not float32 widened."""
    scene = entry.tiny_scene(torch.float64, device="cpu")
    cfg = convert.config_from_dict(dict(dataclasses.asdict(JaxConfig()),
                                        photons=128, photon_retries=4))
    got = trace_photons(scene, cfg)
    replay = trace_photons(scene, cfg, uniform=jax_uniform(cfg.seed))
    assert got.pos.dtype == torch.float64 and got.stored.any()
    for a, b in zip(got, replay):
        assert torch.equal(a, b)
    u = ThreefryUniform(0, "cpu")(0, 0, 0, 1, (4, 16), torch.float64)
    assert u.dtype == torch.float64
    assert not torch.equal(u, u.float().double())


def _renderers(depth, W=32, **kw):
    js = jax_cornell(False)
    ts = port_scene(js)
    jcfg = JaxConfig(min_samples=1, max_samples=1, max_depth=depth,
                     adaptive=False, integrator="staged", seed=5, **kw)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jr = JaxRenderer(js, JaxCamera(pos=TEST_CAMERA_POS,
                                   look_at=TEST_CAMERA_LOOK_AT), jcfg, W, W)
    tr = Renderer(ts, Camera(pos=TEST_CAMERA_POS,
                             look_at=TEST_CAMERA_LOOK_AT), cfg, W, W)
    return js, jr, tr


def test_depth_130_samples_and_wave_match_jax():
    """Depth 130, past Halton's dims: the wave's bounce samples (dims
    2..255 Halton, dims 256..261 the threefry streams stream(key,
    DEEP_DIM_X|Y, d)) are JAX's bit for bit, and the wave equals the JAX
    wave: pixels within 1e-4 on >= 99.9% of the 1,024 lanes and the ray
    counter within 0.05%, as tests/test_torch_render.py holds waves."""
    js, jr, tr = _renderers(130)
    idx = jr.enum.index_image(0).ravel()
    _, _, jsx, jsy = jr._wave_inputs(idx, jnp.uint32(0))
    _, _, tsx, tsy = tr.wave_inputs(0)
    assert tsx.shape == (130, 1024)
    assert np.array_equal(tsx.numpy(), np.asarray(jsx))
    assert np.array_equal(tsy.numpy(), np.asarray(jsy))
    want, (nc, ns) = jr._wave_counted(js, None, idx, jnp.uint32(0))
    got, n = tr.block_wave(0)
    want, got = np.asarray(want), got.reshape(-1, 3).numpy()
    assert np.isfinite(got).all() and got.max() > 0.05
    close = (np.abs(got - want) <= 1e-4).all(-1)
    assert close.mean() >= 0.999, close.mean()
    rays_w = int(nc) + int(ns)
    assert abs(int(n) - rays_w) <= 5e-4 * rays_w, (int(n), rays_w)


def _closed_box(builder, mg):
    b = builder()
    m = b.add_material(b.add_texture_const((0.9, 0.9, 0.9)),
                       b.add_texture_const((0.0, 0.0, 0.0)), 1.0, 1.0, 1.0)
    s = 4.0
    for q in (((-s, -s, -s), (s, -s, -s), (-s, -s, s), (s, -s, s)),
              ((-s, s, -s), (s, s, -s), (-s, s, s), (s, s, s)),
              ((-s, -s, s), (s, -s, s), (-s, s, s), (s, s, s)),
              ((-s, -s, -s), (s, -s, -s), (-s, s, -s), (s, s, -s)),
              ((-s, -s, -s), (-s, -s, s), (-s, s, -s), (-s, s, s)),
              ((s, -s, s), (s, -s, -s), (s, s, s), (s, s, -s))):
        b.add_triangles(mg.quad_mesh(*q), mat_id=m)
    b.add_light((0.0, 3.0, 0.0), (8.0, 8.0, 8.0), 0.3)
    return b


def test_deep_dims_reach_the_radiance():
    """In a closed diffuse box with roulette off every lane bounces 130
    times, so the deep dims' seed moves the image (and only it: Halton
    and the decision hashes do not depend on the seed)."""
    ts = port_scene(jax_build(_closed_box))
    cfg = convert.config_from_dict(dict(
        dataclasses.asdict(JaxConfig()), min_samples=1, max_samples=1,
        max_depth=130, min_depth=130, adaptive=False))
    cam = Camera(pos=(0.5, 0.2, -1.0), look_at=(0.0, 0.0, 3.0))
    a, na = Renderer(ts, cam, cfg, 16, 16).block_wave(0)
    b, nb = Renderer(ts, cam, cfg.replace(seed=6), 16, 16).block_wave(0)
    assert int(na) == int(nb) == 256 * 130 * 2
    assert not torch.equal(a, b)
    assert (a - b).abs().max() < 1e-4


# ---- lowdisc (tests/test_cone_lowdisc.py's values and tolerances) ------

def test_radical_inverse_vdc_values():
    got = tl.radical_inverse_vdc(torch.arange(8)).numpy()
    want = [0.0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875]
    np.testing.assert_allclose(got, want, atol=1e-7)
    i = np.arange(1000, dtype=np.uint32) * 4099
    assert np.array_equal(
        tl.radical_inverse_vdc(torch.as_tensor(i.astype(np.int64))).numpy(),
        np.asarray(jl.radical_inverse_vdc(jnp.asarray(i))))


def test_hammersley_first_coord_is_i_over_n():
    h = tl.hammersley2d(torch.arange(16), 16).numpy()
    np.testing.assert_allclose(h[:, 0], np.arange(16) / 16.0, atol=1e-7)
    assert h[:, 1].min() >= 0 and h[:, 1].max() < 1
    assert np.array_equal(h, np.asarray(jl.hammersley2d(
        jnp.arange(16, dtype=jnp.uint32), 16)))


def test_subrand_additive_recurrence():
    s = tl.subrand(100, start=0.3, prime_index=1).numpy()
    a = np.sqrt(3.0) % 1.0
    want = (0.3 + (np.arange(1, 101)) * a) % 1.0
    np.testing.assert_allclose(s, want, atol=1e-4)
    assert s.min() >= 0 and s.max() < 1
    np.testing.assert_allclose(s, np.asarray(jl.subrand(100, 0.3, 1)),
                               atol=1e-6)


def test_subrand_unit_vec_on_sphere_low_discrepancy():
    v = tl.subrand_unit_vec(256).numpy()
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-5)
    assert np.linalg.norm(v.mean(0)) < 0.05
    np.testing.assert_allclose(v, np.asarray(jl.subrand_unit_vec(256)),
                               atol=1e-6)


def test_ggx_and_sphere_point_match_jax():
    g = tl.importance_sample_ggx(torch.tensor(0.3), torch.tensor(0.7),
                                 torch.tensor(0.5)).numpy()
    assert 0 <= g[0] <= 2 * np.pi + 1e-6
    assert 0 <= g[1] <= np.pi / 2 + 1e-6
    x, y, a = np.random.default_rng(0).uniform(size=(3, 64)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        tl.importance_sample_ggx(*map(torch.from_numpy, (x, y, a))).numpy(),
        np.asarray(jl.importance_sample_ggx(*map(jnp.asarray, (x, y, a)))),
        atol=1e-6)
    np.testing.assert_allclose(
        tl.sphere_point(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jl.sphere_point(jnp.asarray(x), jnp.asarray(y))),
        atol=1e-6)


# ---- Halton scrambles and the enumeration -------------------------------

@pytest.mark.parametrize("scramble,seed", [("random", 0), ("random", 7),
                                           ("none", None)])
def test_scrambles_match_jax(scramble, seed):
    J = jh.HaltonSampler(scramble, seed=seed)
    T = th.HaltonSampler(scramble, seed=seed)
    for b in (2, 3, 4, 5, 97, 1619):
        assert np.array_equal(T._perms[b], np.asarray(J._perms[b]))
    idx = np.arange(0, 40000, 13, dtype=np.uint32)
    for d in (0, 1, 2, 7, 30, 31, 47, 100, 200, 255):
        want = np.asarray(J.sample(d, jnp.asarray(idx)))
        got = T.sample(d, torch.as_tensor(idx.astype(np.int64))).numpy()
        assert np.array_equal(got, want), d


def test_get_index_matches_jax_and_reference_golden():
    rows = np.load(GOLDEN)["enum"]       # (N, 6): w h i x y index
    for w, h in {(int(r[0]), int(r[1])) for r in rows}:
        e, je = th.HaltonEnum(w, h), jh.HaltonEnum(w, h)
        assert e.max_samples_per_pixel == je.max_samples_per_pixel
        sel = rows[(rows[:, 0] == w) & (rows[:, 1] == h)]
        i, x, y = (sel[:, 2], sel[:, 3].astype(np.int64),
                   sel[:, 4].astype(np.int64))
        got = e.get_index(i, x, y).numpy()
        assert np.array_equal(got, sel[:, 5]), (w, h)
        assert np.array_equal(got, np.asarray(je.get_index(
            jnp.asarray(i), jnp.asarray(x.astype(np.int32)),
            jnp.asarray(y.astype(np.int32)))))
    e = th.HaltonEnum(40, 30)
    big = np.full(8, e.max_samples_per_pixel, np.int64)
    xs = np.arange(8)
    assert np.array_equal(e.get_index(big, xs, xs).numpy(), np.asarray(
        jh.HaltonEnum(40, 30).get_index(jnp.asarray(big.astype(np.uint32)),
                                        jnp.asarray(xs), jnp.asarray(xs))))


def test_render_image_matches_jax():
    """16x16, 2 spp, depth 3 on the small Cornell box, tonemapped, with
    the JAX renderer on its megakernel (interpret mode), the main path the
    port follows, as tests/test_torch_render.py: within 1e-4 on >= 99.9%
    of pixels (every pixel here)."""
    js = jax_cornell(False)
    jcfg = JaxConfig(min_samples=2, max_samples=2, max_depth=3,
                     adaptive=False, integrator="mega")
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    want = np.asarray(jax_render_image(
        js, JaxCamera(pos=TEST_CAMERA_POS, look_at=TEST_CAMERA_LOOK_AT),
        jcfg, 16, 16))
    got = render_image(port_scene(js), Camera(pos=TEST_CAMERA_POS,
                                              look_at=TEST_CAMERA_LOOK_AT),
                       cfg, 16, 16).numpy()
    assert got.shape == (16, 16, 3) and 0 <= got.min() and got.max() <= 1
    close = (np.abs(got - want) <= 1e-4).all(-1)
    assert close.mean() >= 0.999, close.mean()
