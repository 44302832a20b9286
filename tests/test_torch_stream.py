"""Port parity of the superchunk trace (K4): its plain walk against the JAX
``_stream_trace`` in interpret mode (tests/test_pallas_intersect.py's
thresholds) and against the brute-force query, with t limits, inactive
lanes and stochastic alpha; the two-level cull against the brute force and
against the superchunk-only walk; and the routing of scenes past 16,384
triangles to it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu.ops import pallas_intersect as pi
from gi_raytracer_tpu_torch.ops import _cuda
from gi_raytracer_tpu_torch.ops import cuda_intersect as ci
from gi_raytracer_tpu_torch.ops import cuda_stream as cs
from gi_raytracer_tpu_torch import routes
from gi_raytracer_tpu_torch.ops.intersect import (chunk_boxes, exact_hit,
                                                  stream_boxes, trace_closest,
                                                  trace_any, trace_tables)
from gi_raytracer_tpu_torch.scene import SceneBuilder
from gi_raytracer_tpu_torch.scene.terrain import terrain_scene, terrain_tris

from _torch_parity import jax_build, port_scene

N_TRIS = 6000          # three superchunks of 2,048
R = 700                # not a multiple of the 256-ray tile


def _soup(alpha):
    """6,000 random triangles in [-5.9, 5.9]^3; with ``alpha`` every other
    one is half transparent (the stochastic-alpha lottery)."""
    def populate(builder, mg):
        rng = np.random.default_rng(11)
        b = builder()
        t0 = b.add_texture_const((1, 1, 1))
        m0 = b.add_material(t0, t0, 1.0, 1.0, 1.0)
        m1 = b.add_material(t0, t0, 1.0, 0.5 if alpha else 1.0, 1.0)
        c = rng.uniform(-5, 5, (N_TRIS, 1, 3))
        tris = c + rng.uniform(-0.9, 0.9, (N_TRIS, 3, 3))
        b.add_triangles(tris[0::2], None, None, m0)
        b.add_triangles(tris[1::2], None, None, m1)
        return b
    return populate


@pytest.fixture(scope="module", params=[False, True],
                ids=["opaque", "alpha"])
def case(request):
    js = jax_build(_soup(request.param))
    ts = port_scene(js)
    assert ts.all_opaque is not request.param
    rng = np.random.default_rng(4)
    # origins inside the scene's box: every hit lies within the JAX
    # kernel's world-diagonal cap, which the port does not apply
    ro = rng.uniform(-5, 5, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return js, ts, ro, rd


def _jax_stream(js, ro, rd, t_lim, active, rid, salt, any_hit):
    pad = (-R) % pi.RAY_TILE

    def p(x, value=0):
        return jnp.pad(jnp.asarray(x), ((0, pad), (0, 0)),
                       constant_values=value)

    diag = jnp.linalg.norm(
        (js.world_max - js.world_min).astype(jnp.float32)) * 1.001
    feat_sc, scbox = pi.build_tri_features_stream(js)
    assert feat_sc.shape[0] // pi.SC_ROWS >= 3
    _, prim = pi._stream_trace(
        feat_sc, scbox, p(ro), p(rd), p(t_lim[:, None]),
        p(active.astype(np.float32)[:, None]),
        p(rid.astype(np.int32)[:, None]),
        jnp.full((1, 1), salt, jnp.int32), diag, any_hit=any_hit,
        all_opaque=js.all_opaque, interpret=True)
    return torch.from_numpy(np.asarray(prim[:R]).astype(np.int32))


def _port(ts, ro, rd, t_lim, active, rid, salt, any_hit, plain_brute=False):
    feat, acc = trace_tables(ts)
    args = (torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(t_lim), torch.from_numpy(active),
            torch.from_numpy(rid), salt, 1e-5, any_hit, ts.all_opaque)
    if plain_brute:
        return ci.prim_query_brute(feat, acc, *args)[1]
    return cs.prim_query_stream_plain(feat, acc, stream_boxes(ts),
                                      chunk_boxes(ts), *args)[1]


def _assert_closest_match(ts, ro, rd, got, want):
    """Equal hit masks; prim ids equal on >= 99% of hits; the winners'
    exact t within rtol 1e-5."""
    o, d = torch.from_numpy(ro), torch.from_numpy(rd)
    tg, _, _, pg = exact_hit(ts, o, d, got, 1e-5)
    tw, _, _, pw = exact_hit(ts, o, d, want, 1e-5)
    hits = pw >= 0
    assert hits.float().mean() > 0.2
    assert torch.equal(pg >= 0, hits)
    assert (pg == pw)[hits].float().mean() >= 0.99
    np.testing.assert_allclose(tg[hits].numpy(), tw[hits].numpy(), rtol=1e-5)


def _inputs(case, limit, active_every, rid_mul):
    js, ts, ro, rd = case
    t_lim = np.full(R, 3.0e38 if limit is None else limit, np.float32)
    active = np.zeros(R, bool)
    active[::active_every] = True
    rid = (np.arange(R) * rid_mul + 5).astype(np.int64)
    return js, ts, ro, rd, t_lim, active, rid


@pytest.mark.parametrize("limit,active_every,salt", [
    (None, 1, 0), (4.0, 1, 77), (None, 3, 12345)],
    ids=["plain", "t_max", "active"])
def test_closest_matches_jax_stream(case, limit, active_every, salt):
    js, ts, ro, rd, t_lim, active, rid = _inputs(case, limit, active_every, 3)
    want = _jax_stream(js, ro, rd, t_lim, active, rid, salt, False)
    got = _port(ts, ro, rd, t_lim, active, rid, salt, False)
    assert (got[~torch.from_numpy(active)] == -1).all()
    _assert_closest_match(ts, ro, rd, got, want)


@pytest.mark.parametrize("limit,salt", [(None, 0), (2.5, 99)],
                         ids=["unlimited", "t_max"])
def test_any_hit_matches_jax_stream(case, limit, salt):
    js, ts, ro, rd, t_lim, active, rid = _inputs(case, limit, 2, 1)
    want = _jax_stream(js, ro, rd, t_lim, active, rid, salt, True)
    got = _port(ts, ro, rd, t_lim, active, rid, salt, True)
    assert 0.05 < (want >= 0).float().mean() < 0.95
    assert torch.equal(got >= 0, want >= 0)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_stream_walk_matches_brute_force(case, any_hit):
    _, ts, ro, rd, t_lim, active, rid = _inputs(case, 6.0, 1, 7)
    got = _port(ts, ro, rd, t_lim, active, rid, 31, any_hit)
    want = _port(ts, ro, rd, t_lim, active, rid, 31, any_hit,
                 plain_brute=True)
    if any_hit:
        assert torch.equal(got >= 0, want >= 0)
    else:
        _assert_closest_match(ts, ro, rd, got, want)


def test_stream_walk_culls_and_counts_visits():
    """Coherent rays from one point visit fewer superchunks than there
    are, and the per-tile counters report each tile's walk: the tests made
    are at most those of every ray in every visited superchunk, at most
    those of the superchunk-only walk (every row of a needed superchunk),
    and any hit, which stops at its first hit, makes fewer than closest
    hit."""
    ts = terrain_scene(SceneBuilder, 80).build(device="cpu")
    feat, acc = trace_tables(ts)
    box = stream_boxes(ts)
    cbox = chunk_boxes(ts)
    n_sc = box.shape[1]
    assert n_sc == cs.n_superchunks(feat.shape[0]) == 7
    g = torch.Generator().manual_seed(0)
    ro = torch.tensor([[0.0, 18.0, -30.0]]).expand(600, 3).contiguous()
    look = torch.rand((600, 3), generator=g) * torch.tensor([8.0, 0, 8.0]) \
        - torch.tensor([4.0, 0, 4.0])
    rd = look - ro
    rd = rd / rd.norm(dim=1, keepdim=True)
    args = (ro, rd, torch.full((600,), ci.BIG), torch.ones(600, dtype=bool),
            torch.arange(600), 0)
    _, p, visits, tests = cs.prim_query_stream(feat, acc, box, cbox, *args,
                                               return_counts=True)
    assert visits.shape == tests.shape == (3,)
    assert visits.dtype == tests.dtype == torch.int32
    assert (visits >= 1).all() and (visits < n_sc).all()
    assert (tests > 0).all()
    assert (tests <= visits * cs.RAY_TILE * cs.SC_TRIS).all()
    assert torch.equal(p, ci.prim_query_brute(feat, acc, *args)[1])
    _, p_sc, v_sc, t_sc = ci.walk_plain(feat, acc, box, box, *args, 1e-5,
                                        False, True, True, cs.SC_TRIS,
                                        cs.SC_TRIS)
    assert torch.equal(p_sc, p) and torch.equal(v_sc, visits)
    assert (tests <= t_sc).all() and tests.sum() * 4 < t_sc.sum()
    _, _, _, any_tests = cs.prim_query_stream(
        feat, acc, box, cbox, *args, 1e-5, True, ts.all_opaque,
        return_counts=True)
    assert (any_tests < tests).all()


def test_scenes_past_the_cap_route_to_the_stream_trace():
    """A terrain just past 16,384 triangles goes through K4's plain walk,
    one at 16,384 or below through K2's; the answers agree."""
    big = terrain_scene(SceneBuilder, 92).build(device="cpu")     # 16,562
    small = terrain_scene(SceneBuilder, 91).build(device="cpu")   # 16,200
    assert terrain_tris(92) > routes.VMEM_TRI_CAP >= terrain_tris(91)
    assert routes.trace(big)[0] == "k4" and routes.trace(small)[0] == "k2"
    g = torch.Generator().manual_seed(1)
    ro = torch.tensor([[0.0, 18.0, -30.0]]).expand(300, 3).contiguous()
    rd = torch.randn((300, 3), generator=g) * 0.3 \
        + torch.tensor([0.0, -0.5, 1.0])
    rd = rd / rd.norm(dim=1, keepdim=True)
    for scene, used, unused in ((big, "stream", "intersect"),
                                (small, "intersect", "stream")):
        _cuda.reset_launches()
        hit = trace_closest(scene, ro, rd)
        occ = trace_any(scene, ro, rd, torch.full((300,), 1e3))
        assert _cuda.plain_calls[used] == 2 and _cuda.plain_calls[unused] == 0
        assert torch.equal(occ, hit.prim >= 0)
        feat, acc = trace_tables(scene)
        _, brute = ci.prim_query_brute(feat, acc, ro, rd,
                                       torch.full((300,), ci.BIG),
                                       torch.ones(300, dtype=bool),
                                       torch.arange(300), 0)
        assert torch.equal(hit.prim >= 0, brute >= 0)
        assert (hit.prim == brute).float().mean() >= 0.99
    with pytest.raises(ValueError):
        cs._stream_cuda(*trace_tables(big), stream_boxes(big),
                        chunk_boxes(big), ro, rd,
                        torch.full((300,), ci.BIG), torch.ones(300, dtype=bool),
                        torch.arange(300), 0, 1e-5, False, True, False)


@pytest.mark.parametrize("walk", ["K4", "K2"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_chunk_cull_keeps_the_brute_force_winner(case, walk, any_hit):
    """On the random soup (SAH leaves of random triangles: the 128-row
    chunk boxes overlap one another) the two-level walk (K4) and the chunk
    walk (K2) keep the brute force's hit mask, and its winner on every
    lane but counted near ties: lanes whose winners' exact t differ by at
    most 2^-7 relative (the approximate ordering t).  The per-tile counts
    stay within every ray of a visiting tile testing every row of a
    visited group."""
    _, ts, ro, rd, t_lim, active, rid = _inputs(case, 7.0, 1, 5)
    feat, acc = trace_tables(ts)
    cbox = chunk_boxes(ts)
    lo, hi = cbox[0:3], cbox[3:6]
    # the soup's chunk boxes overlap: most pairs of them intersect
    overlap = ((lo[:, :, None] <= hi[:, None, :])
               & (hi[:, :, None] >= lo[:, None, :])).all(0)
    assert overlap.float().mean() > 0.5
    args = (torch.from_numpy(ro), torch.from_numpy(rd),
            torch.from_numpy(t_lim), torch.from_numpy(active),
            torch.from_numpy(rid), 23, 1e-5, any_hit, ts.all_opaque)
    if walk == "K4":
        _, got, visits, tests = cs.prim_query_stream_plain(
            feat, acc, stream_boxes(ts), cbox, *args, return_counts=True)
        rows = cs.SC_TRIS
    else:
        _, got, visits, tests = ci.prim_query_plain(feat, acc, cbox, *args,
                                                    return_counts=True)
        rows = ci.CHUNK_ROWS
    _, want = ci.prim_query_brute(feat, acc, *args)
    assert (tests <= visits * cs.RAY_TILE * rows).all()
    assert (tests > 0).all()
    assert torch.equal(got >= 0, want >= 0)
    if any_hit:
        return
    o, d = torch.from_numpy(ro), torch.from_numpy(rd)
    tg = exact_hit(ts, o, d, got, 1e-5)[0]
    tw = exact_hit(ts, o, d, want, 1e-5)[0]
    differ = got != want
    rel = ((tg - tw).abs() / tw.abs())[differ]
    assert (rel <= 2.0 ** -7).all()
    assert differ.sum() <= 0.01 * R
