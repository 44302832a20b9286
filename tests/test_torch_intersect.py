"""Port parity: the dense trace's plain version (the CPU side of the K2
kernel, a walk over 128-triangle chunks) against the JAX Pallas trace in
interpret mode, with the tolerances of tests/test_pallas_intersect.py, and
against the brute-force query."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu.ops.pallas_intersect import pallas_closest_hit
from gi_raytracer_tpu.render.camera import Camera as JaxCamera, primary_rays
from gi_raytracer_tpu.scene import SceneBuilder as JaxBuilder
from gi_raytracer_tpu_torch.ops import cuda_intersect as ci
from gi_raytracer_tpu_torch.ops.intersect import (chunk_boxes, exact_hit,
                                                  trace_closest, trace_any,
                                                  trace_tables)

from _torch_parity import (jax_cornell, port_scene, TEST_CAMERA_POS,
                           TEST_CAMERA_LOOK_AT)


def _random_tri_scene(rng):
    """tests/test_pallas_intersect.py's fixture scene."""
    b = JaxBuilder()
    t0 = b.add_texture_const((1, 1, 1))
    m = b.add_material(t0, t0, 1.0, 1.0, 1.0)
    centers = rng.uniform(-5, 5, (300, 3))
    tris = centers[:, None, :] + rng.uniform(-0.9, 0.9, (300, 3, 3))
    b.add_triangles(tris, None, None, m)
    return b.build(dtype=np.float32)


@pytest.fixture(scope="module")
def random_case():
    rng = np.random.default_rng(7)
    js = _random_tri_scene(rng)
    R = 700
    ro = rng.uniform(-8, 8, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return js, port_scene(js), ro, rd


@pytest.fixture(scope="module")
def cornell_case():
    js = jax_cornell(False)
    W = H = 32
    rng = np.random.default_rng(3)
    cam = JaxCamera(pos=TEST_CAMERA_POS, look_at=TEST_CAMERA_LOOK_AT)
    ro, rd = primary_rays(cam, W, H,
                          jnp.asarray(rng.uniform(0, W, 1024), jnp.float32),
                          jnp.asarray(rng.uniform(0, H, 1024), jnp.float32))
    return js, port_scene(js), np.array(ro), np.array(rd)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_hits_match(got, want):
    """test_pallas_intersect.py's gates: equal hit masks, t rtol 1e-5 on
    hits, prim ids equal on >= 99% (exact-tie distances)."""
    gt, wt = got.t.numpy(), np.asarray(want.t)
    hits = np.isfinite(wt)
    assert (np.isfinite(gt) == hits).all()
    np.testing.assert_allclose(gt[hits], wt[hits], rtol=1e-5)
    same = got.prim.numpy() == np.asarray(want.prim)
    assert not hits.any() or same[hits].mean() >= 0.99


@pytest.mark.parametrize("case", ["random_case", "cornell_case"])
def test_closest_matches_jax(case, request):
    js, ts, ro, rd = request.getfixturevalue(case)
    want = pallas_closest_hit(js, jnp.asarray(ro), jnp.asarray(rd),
                              interpret=True)
    got = trace_closest(ts, _t(ro), _t(rd))
    assert np.isfinite(got.t.numpy()).sum() > 20    # the query hits things
    _assert_hits_match(got, want)
    # the exact (t, u, v) of the winner
    hits = np.isfinite(np.asarray(want.t))
    for name in ("u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy()[hits],
                                   np.asarray(getattr(want, name))[hits],
                                   atol=1e-5)


@pytest.mark.parametrize("case", ["random_case", "cornell_case"])
def test_any_hit_matches_jax(case, request):
    js, ts, ro, rd = request.getfixturevalue(case)
    for lim in (None, 3.0):
        tm = None if lim is None else jnp.full(ro.shape[0], lim, jnp.float32)
        want = pallas_closest_hit(js, jnp.asarray(ro), jnp.asarray(rd),
                                  t_max=tm, any_hit=True, interpret=True)
        got = trace_any(ts, _t(ro), _t(rd),
                        None if lim is None else torch.full((ro.shape[0],),
                                                            lim))
        assert np.array_equal(got.numpy(), np.asarray(want.prim) >= 0)


def test_t_max_and_active(random_case):
    js, ts, ro, rd = random_case
    ref = pallas_closest_hit(js, jnp.asarray(ro), jnp.asarray(rd),
                             interpret=True)
    rt = np.asarray(ref.t)
    hits = np.isfinite(rt)
    lim = np.where(hits, rt * 0.5, 1.0).astype(np.float32)
    want = pallas_closest_hit(js, jnp.asarray(ro), jnp.asarray(rd),
                              t_max=jnp.asarray(lim), interpret=True)
    got = trace_closest(ts, _t(ro), _t(rd), t_max=_t(lim))
    assert (got.prim.numpy()[hits] == -1).all()
    _assert_hits_match(got, want)
    act = np.zeros(ro.shape[0], bool)
    act[::3] = True
    want = pallas_closest_hit(js, jnp.asarray(ro), jnp.asarray(rd),
                              active=jnp.asarray(act), interpret=True)
    got = trace_closest(ts, _t(ro), _t(rd), active=_t(act))
    assert (got.prim.numpy()[~act] == -1).all()
    _assert_hits_match(got, want)


def test_stochastic_alpha_matches_jax():
    """Opacity-0 / refractive layers, and a half-transparent layer whose
    accept decisions come from the kernel's alpha hash of (ray id, prim,
    salt): the port must make the same decisions as the TPU kernel."""
    b = JaxBuilder()
    t0 = b.add_texture_const((1, 1, 1))
    m0 = b.add_material(t0, t0, 1.0, 0.0, 1.0)   # opacity 0: never hit
    m1 = b.add_material(t0, t0, 1.0, 0.5, 1.0)   # opacity 0.5: a lottery
    m2 = b.add_material(t0, t0, 1.0, 0.0, 1.5)   # refractive: always hit
    b.add_triangle([(-9, -9, 2), (9, -9, 2), (0, 9, 2)], mat_id=m0)
    b.add_triangle([(-9, -9, 3), (9, -9, 3), (0, 9, 3)], mat_id=m1)
    b.add_triangle([(-9, -9, 5), (9, -9, 5), (0, 9, 5)], mat_id=m2)
    js = b.build(dtype=np.float32)
    ts = port_scene(js)
    assert not ts.all_opaque
    R = 512
    rng = np.random.default_rng(5)
    ro = np.zeros((R, 3), np.float32)
    ro[:, :2] = rng.uniform(-1, 1, (R, 2))
    rd = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (R, 1))
    rid = np.arange(R, dtype=np.int32) * 7 + 11
    for salt in (0, 12345):
        want = pallas_closest_hit(js, jnp.asarray(ro), jnp.asarray(rd),
                                  salt=salt, ray_id=jnp.asarray(rid),
                                  interpret=True)
        got = trace_closest(ts, _t(ro), _t(rd), salt=salt, ray_id=_t(rid))
        wp = np.asarray(want.prim)
        assert 0.2 < (wp == 1).mean() < 0.8     # the lottery is live
        assert np.array_equal(got.prim.numpy(), wp)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                   rtol=1e-6)


def test_plain_trace_ray_blocks_agree(random_case):
    """The brute force's ray blocking (it bounds memory at full size)
    gives the same answer as one block."""
    _, ts, ro, rd = random_case
    feat, acc = trace_tables(ts)
    R = ro.shape[0]
    args = (feat, acc, _t(ro), _t(rd), torch.full((R,), ci.BIG),
            torch.ones(R, dtype=torch.bool), torch.arange(R), 0)
    want = ci.prim_query_brute(*args)
    old = ci._PLAIN_BLOCK
    try:
        ci._PLAIN_BLOCK = 4096          # 10 rays x 384 triangle slots
        got = ci.prim_query_brute(*args)
    finally:
        ci._PLAIN_BLOCK = old
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("limit,active_every,opaque", [
    (None, 1, True), (3.0, 1, True), (None, 3, True), (5.0, 2, False)],
    ids=["plain", "t_max", "active", "alpha"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_chunk_walk_matches_brute_force(random_case, limit, active_every,
                                        opaque, any_hit):
    """K2's plain walk (ordered 128-triangle chunks behind the tile cap)
    against the brute force: equal hit masks, and for closest hit equal
    winners (the exact t within rtol 1e-5); inactive lanes miss; the
    per-tile counts within every ray testing every row of every visited
    chunk.  ``alpha`` gives half the triangles opacity 0.5."""
    _, ts, ro, rd = random_case
    feat, acc = trace_tables(ts)
    if not opaque:
        acc = torch.where(torch.arange(acc.shape[0]) % 2 == 1,
                          torch.clamp(acc, max=0.5), acc)
    R = ro.shape[0]
    act = torch.zeros(R, dtype=torch.bool)
    act[::active_every] = True
    args = (_t(ro), _t(rd), torch.full((R,), ci.BIG if limit is None
                                       else limit), act,
            torch.arange(R) * 3 + 1, 99, 1e-5, any_hit, opaque)
    _, got, visits, tests = ci.prim_query(feat, acc, chunk_boxes(ts), *args,
                                          return_counts=True)
    _, want = ci.prim_query_brute(feat, acc, *args)
    assert visits.shape == tests.shape == (-(-R // ci.RAY_TILE),)
    assert (tests <= visits * ci.RAY_TILE * ci.CHUNK_ROWS).all()
    assert (got[~act] == -1).all()
    assert 10 < (want >= 0).sum() < act.sum()
    assert torch.equal(got >= 0, want >= 0)
    if not any_hit:
        hits = want >= 0
        tg = exact_hit(ts, _t(ro), _t(rd), got, 1e-5)[0]
        tw = exact_hit(ts, _t(ro), _t(rd), want, 1e-5)[0]
        assert (got == want)[hits].float().mean() >= 0.99
        np.testing.assert_allclose(tg[hits].numpy(), tw[hits].numpy(),
                                   rtol=1e-5)
