"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``chip_smoke.py`` makes the same comparisons at the main path's shapes.)
"""

import numpy as np
import pytest
import torch

from gi_raytracer_tpu_torch.config import RenderConfig
from gi_raytracer_tpu_torch.ops import _cuda
from gi_raytracer_tpu_torch.ops import cuda_intersect as ci
from gi_raytracer_tpu_torch.ops import cuda_stream as cs
from gi_raytracer_tpu_torch.ops.cuda_megakernel import radiance_wave_mega
from gi_raytracer_tpu_torch.ops.intersect import (chunk_boxes, stream_boxes,
                                                  trace_closest, trace_tables)
from gi_raytracer_tpu_torch.render import Camera, Renderer
from gi_raytracer_tpu_torch.render.geom import normalize
from gi_raytracer_tpu_torch.render.integrator import radiance_wave
from gi_raytracer_tpu_torch.render.photon import (PhotonBatch,
                                                  build_photon_map,
                                                  sample_photons)
from gi_raytracer_tpu_torch.render.photon_knn import sample_photons_tiled
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
from gi_raytracer_tpu_torch.scene.cornell import (cornell_box, CAMERA_POS,
                                                  CAMERA_LOOK_AT)
from gi_raytracer_tpu_torch.scene.terrain import terrain_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scene(dev):
    return cornell_box(SceneBuilder, meshgen, True).build(device=dev)


def _random_rays(dev, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    ro = (torch.rand((n, 3), generator=g, device=dev) * 2 - 1) * 3.9
    rd = normalize(torch.randn((n, 3), generator=g, device=dev))
    return ro, rd


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_trace_kernel_matches_plain(dev, scene, any_hit):
    """K2 against its plain chunk walk (prim ids, per-tile visits and
    tests) and the brute force, on random rays in the Cornell box."""
    feat, accept = trace_tables(scene)
    R = 65536
    ro, rd = _random_rays(dev, R, 0)
    args = (ro, rd, torch.full((R,), ci.BIG, device=dev),
            torch.ones(R, dtype=torch.bool, device=dev),
            torch.arange(R, device=dev), 0, 1e-5, any_hit, scene.all_opaque)
    _walk_matches("intersect", feat, accept, (chunk_boxes(scene),), args,
                  any_hit)


def _walk_matches(kernel, feat, accept, boxes, args, any_hit):
    """K2 or K4 against its plain walk (per-tile visits and tests too) and
    the brute force; returns the kernel's (prim, visits, tests)."""
    query, plain = ((ci.prim_query, ci.prim_query_plain) if kernel ==
                    "intersect" else (cs.prim_query_stream,
                                      cs.prim_query_stream_plain))
    before = _cuda.launches[kernel]
    _, p_k, v_k, n_k = query(feat, accept, *boxes, *args, return_counts=True)
    assert _cuda.launches[kernel] == before + 1
    _, p_p, v_p, n_p = plain(feat, accept, *boxes, *args, return_counts=True)
    _, p_b = ci.prim_query_brute(feat, accept, *args)
    assert (v_k == v_p).float().mean() > 0.99
    assert abs(int(n_k.sum()) - int(n_p.sum())) <= 1e-3 * int(n_p.sum())
    for ref in (p_p, p_b):
        assert ((p_k >= 0) == (ref >= 0)).float().mean() >= 0.999
        if not any_hit:
            assert (p_k == ref).float().mean() >= 0.999
    return p_k, v_k, n_k


def _checker_ball(dev):
    """A checker-textured sphere mesh on a floor: K1's checker path."""
    b = SceneBuilder()
    chk = b.add_texture_checker(8, (0.9, 0.1, 0.1), (0.1, 0.1, 0.9))
    white = b.add_texture_const((0.9, 0.9, 0.9))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    v, n, uv = meshgen.sphere_mesh((0.0, 0.0, 0.0), 1.0, 2)
    b.add_triangles(v, n, uv, mat_id=b.add_material(chk, black, 1.0, 1.0))
    b.add_triangles(meshgen.quad_mesh((-4, -1, -4), (4, -1, -4), (-4, -1, 4),
                                      (4, -1, 4)),
                    mat_id=b.add_material(white, black, 1.0, 1.0))
    b.add_light((0.0, 3.0, 0.0), (8.0, 8.0, 8.0), 0.3)
    return b.build(device=dev)


@pytest.mark.parametrize("which", ["cornell", "checker"])
def test_megakernel_matches_plain(dev, scene, which):
    """64x64 lanes, depth 8, no map: lanes within 1e-4 on >= 99.9%, ray
    counts within 0.05%."""
    cfg = RenderConfig(min_samples=1, max_samples=1, adaptive=False,
                       max_depth=8)
    if which == "checker":
        scene = _checker_ball(dev)
        cam = Camera(pos=(0.0, 0.5, -4.0), look_at=(0.0, 0.0, 0.0))
    else:
        cam = Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT)
    r = Renderer(scene, cam, cfg, 64, 64)
    ro, rd, sx, sy = r.wave_inputs(0)
    lane = torch.arange(ro.shape[0], device=dev)
    got, (gc, gs) = radiance_wave_mega(scene, cfg, ro, rd, sx, sy, lane)
    want, (wc, ws) = radiance_wave(scene, cfg, ro, rd, sx, sy, 0,
                                   lane_ids=lane, plain=True)
    assert torch.isfinite(got).all()
    off = ((got - want).abs().max(-1).values > 1e-4).float().mean()
    assert off < 0.001
    assert abs(int(gc) - int(wc)) <= 5e-4 * int(wc)
    assert abs(int(gs) - int(ws)) <= 5e-4 * int(ws)


def test_knn_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    P = 20000
    pos = torch.randn((P, 3), generator=g, device=dev) * 0.3
    d = normalize(torch.randn((P, 3), generator=g, device=dev))
    col = torch.rand((P, 3), generator=g, device=dev)
    pm = build_photon_map(PhotonBatch(pos, d, col, torch.ones(
        P, dtype=torch.bool, device=dev)), (-1.5,) * 3, (1.5,) * 3)
    q = torch.randn((8192, 3), generator=g, device=dev) * 0.4
    qd = normalize(torch.randn((8192, 3), generator=g, device=dev))
    q[:16] = 1e30                               # far sentinels estimate 0
    got = sample_photons_tiled(pm, q, qd, 32)
    want = sample_photons(pm, q, qd, 32)
    assert (got[:16] == 0).all()
    close = ((got - want).abs() <= 1e-6 + 2e-4 * want.abs()).all(-1)
    assert close.float().mean() >= 0.999
    with pytest.raises(NotImplementedError):
        sample_photons_tiled(pm, q.requires_grad_(), qd, 32)


def test_default_build_lands_on_the_card(dev):
    scene = cornell_box(SceneBuilder, meshgen, False).build()
    assert scene.device.type == "cuda"


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_stream_kernel_matches_plain(dev, any_hit):
    """K4 against its plain walk and the brute force on a 79,202-triangle
    terrain: random rays inside the world box, and rays from the camera in
    tiles that each aim at a small patch of the terrain (narrow frusta, as
    the renderer's pixel blocks are), which the cull lets skip
    superchunks."""
    big = terrain_scene(SceneBuilder, 200).build(device=dev)
    feat, accept = trace_tables(big)
    box = stream_boxes(big)
    R = 8192
    g = torch.Generator(device=dev).manual_seed(3)
    lo, hi = big.world_min, big.world_max
    ro = torch.cat([lo + (hi - lo) * torch.rand((R // 2, 3), generator=g,
                                                device=dev),
                    torch.tensor([[0.0, 18.0, -30.0]], device=dev)
                    .expand(R // 2, 3)]).contiguous()
    n_tiles = R // 2 // cs.RAY_TILE
    centre = (torch.rand((n_tiles, 1, 3), generator=g, device=dev) - 0.5) \
        * 32.0
    aim = (centre + (torch.rand((n_tiles, cs.RAY_TILE, 3), generator=g,
                                device=dev) - 0.5) * 2.0).reshape(-1, 3)
    aim[:, 1] = 0.0
    rd = torch.cat([normalize(torch.randn((R // 2, 3), generator=g,
                                          device=dev)),
                    normalize(aim - ro[R // 2:])]).contiguous()
    args = (ro, rd, torch.full((R,), ci.BIG, device=dev),
            torch.ones(R, dtype=torch.bool, device=dev),
            torch.arange(R, device=dev), 0, 1e-5, any_hit, big.all_opaque)
    _, v_k, _ = _walk_matches("stream", feat, accept,
                              (box, chunk_boxes(big)), args, any_hit)
    assert (v_k < box.shape[1]).any()
    before = _cuda.launches["stream"]
    trace_closest(big, ro, rd)
    assert _cuda.launches["stream"] == before + 1


def _alpha_soup(dev):
    """6,000 random triangles in [-5.9, 5.9]^3 (three superchunks), every
    other one half transparent: K4's stochastic-alpha branch."""
    rng = np.random.default_rng(11)
    b = SceneBuilder()
    t0 = b.add_texture_const((1, 1, 1))
    m0 = b.add_material(t0, t0, 1.0, 1.0, 1.0)
    m1 = b.add_material(t0, t0, 1.0, 0.5, 1.0)
    tris = rng.uniform(-5, 5, (6000, 1, 3)) \
        + rng.uniform(-0.9, 0.9, (6000, 3, 3))
    b.add_triangles(tris[0::2], None, None, m0)
    b.add_triangles(tris[1::2], None, None, m1)
    return b.build(device=dev)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_stream_kernel_alpha_matches_plain(dev, any_hit):
    """The alpha lottery keyed on the caller's ray ids (not 0..R-1) and
    the global prim id, with a salt, a t limit and inactive lanes."""
    soup = _alpha_soup(dev)
    assert not soup.all_opaque
    feat, accept = trace_tables(soup)
    box = stream_boxes(soup)
    assert box.shape[1] == 3
    R = 4096
    g = torch.Generator(device=dev).manual_seed(5)
    ro = ((torch.rand((R, 3), generator=g, device=dev) - 0.5) * 10.0)
    rd = normalize(torch.randn((R, 3), generator=g, device=dev))
    active = torch.rand(R, generator=g, device=dev) < 0.9
    rid = torch.randperm(R, generator=g, device=dev) * 7 + 3
    args = (ro, rd, torch.full((R,), 6.0, device=dev), active, rid, 12345,
            1e-5, any_hit, soup.all_opaque)
    _walk_matches("stream", feat, accept, (box, chunk_boxes(soup)), args,
                  any_hit)


@pytest.mark.parametrize("kernel", ["stream", "intersect"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_walk_compaction_edge_cases(dev, kernel, any_hit):
    """Three tiles on the half-transparent soup: every lane dead (nothing
    visited, nothing tested, every lane a miss), one live lane, and 256
    live rays whose chunks overflow one shared-memory stage (they enter
    more than two chunks of a superchunk); kernel and plain walk agree on
    every lane and every tile's counts."""
    soup = _alpha_soup(dev)
    feat, accept = trace_tables(soup)
    cbox = chunk_boxes(soup)
    boxes = (stream_boxes(soup), cbox) if kernel == "stream" else (cbox,)
    T = cs.RAY_TILE
    g = torch.Generator(device=dev).manual_seed(9)
    ro = ((torch.rand((3 * T, 3), generator=g, device=dev) - 0.5) * 10.0)
    rd = normalize(torch.randn((3 * T, 3), generator=g, device=dev))
    active = torch.zeros(3 * T, dtype=torch.bool, device=dev)
    active[T + 17] = True
    active[2 * T:] = True
    t_lim = torch.full((3 * T,), ci.BIG, device=dev)
    entered = ci.slab_scores(cbox, ro[2 * T:], rd[2 * T:], t_lim[2 * T:]) \
        < ci.BIG
    per_sc = entered.any(0)[:cbox.shape[1] // 16 * 16].view(-1, 16).sum(1)
    assert per_sc.max() > 2
    args = (ro, rd, t_lim, active, torch.arange(3 * T, device=dev) * 5 + 1,
            777, 1e-5, any_hit, soup.all_opaque)
    query, plain = ((ci.prim_query, ci.prim_query_plain) if kernel ==
                    "intersect" else (cs.prim_query_stream,
                                      cs.prim_query_stream_plain))
    t_k, p_k, v_k, n_k = query(feat, accept, *boxes, *args,
                               return_counts=True)
    _, p_p, v_p, n_p = plain(feat, accept, *boxes, *args,
                             return_counts=True)
    assert (p_k[:T] == -1).all() and (t_k[:T] == ci.BIG).all()
    assert (p_k[T:2 * T][torch.arange(T, device=dev) != 17] == -1).all()
    assert v_k[0] == 0 and n_k[0] == 0
    assert v_k[1] >= 1 and 0 < n_k[1] <= v_k[1] * 16 * ci.CHUNK_ROWS
    assert torch.equal(v_k, v_p) and torch.equal(n_k, n_p)
    assert torch.equal(p_k, p_p)


def _plane_stack(dev, n_planes):
    """``n_planes`` opaque planes of 128 triangles (8x8 quads over
    [-1, 1]^2) at z = 1, 2, ..., and one quad at x = 5, z = n_planes + 8."""
    g = np.linspace(-1.0, 1.0, 9)
    x0, y0 = np.meshgrid(g[:-1], g[:-1], indexing="ij")
    x0, y0, s = x0.ravel(), y0.ravel(), g[1] - g[0]
    quad = np.stack([np.stack([x0, y0], -1), np.stack([x0 + s, y0], -1),
                     np.stack([x0, y0 + s], -1),
                     np.stack([x0 + s, y0 + s], -1)], 1)     # (64, 4, 2)
    plane = np.concatenate([quad[:, [0, 1, 2]], quad[:, [1, 3, 2]]])
    tris = [np.concatenate([plane, np.full((128, 3, 1), float(z))], -1)
            for z in range(1, n_planes + 1)]
    zf = n_planes + 8.0
    tris.append(np.array([[[4.5, -0.5, zf], [5.5, -0.5, zf], [4.5, 0.5, zf]],
                          [[5.5, -0.5, zf], [5.5, 0.5, zf], [4.5, 0.5, zf]]]))
    b = SceneBuilder()
    t0 = b.add_texture_const((1, 1, 1))
    b.add_triangles(np.concatenate(tris), None, None,
                    b.add_material(t0, t0, 1.0, 1.0, 1.0))
    return b.build(device=dev)


@pytest.mark.parametrize("kernel", ["stream", "intersect"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_walk_visits_needed_by_no_ray(dev, kernel, any_hit):
    """Runs of visited chunks that no ray needs, then one that a ray does:
    on a stack of 40 planes, rays with a near hit on the first plane and
    one ray per tile that passes beside the stack to a quad behind it.
    That ray keeps the tile's cap open, so the tile visits every chunk its
    near rays enter while they need none past the first plane's; the
    double buffer is written on every visit, and the last visit reads it.
    Tile 0 has 255 near rays, tile 1 one (the rest dead); kernel and plain
    walk agree on every lane and every tile's counts."""
    stack = _plane_stack(dev, 40)
    feat, accept = trace_tables(stack)
    cbox = chunk_boxes(stack)
    boxes = (stream_boxes(stack), cbox) if kernel == "stream" else (cbox,)
    T = cs.RAY_TILE
    g = torch.Generator(device=dev).manual_seed(13)
    ro = torch.zeros((2 * T, 3), device=dev)
    ro[:, :2] = (torch.rand((2 * T, 2), generator=g, device=dev) - 0.5) * 1.8
    ro[T - 1] = ro[2 * T - 1] = torch.tensor([5.0, 0.0, 0.0], device=dev)
    rd = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(2 * T, 3) \
        .contiguous()
    active = torch.ones(2 * T, dtype=torch.bool, device=dev)
    active[T + 1:2 * T - 1] = False
    args = (ro, rd, torch.full((2 * T,), ci.BIG, device=dev), active,
            torch.arange(2 * T, device=dev), 0, 1e-5, any_hit,
            stack.all_opaque)
    query, plain = ((ci.prim_query, ci.prim_query_plain) if kernel ==
                    "intersect" else (cs.prim_query_stream,
                                      cs.prim_query_stream_plain))
    t_k, p_k, v_k, n_k = query(feat, accept, *boxes, *args,
                               return_counts=True)
    t_p, p_p, v_p, n_p = plain(feat, accept, *boxes, *args,
                               return_counts=True)
    assert torch.equal(v_k, v_p) and torch.equal(n_k, n_p)
    assert torch.equal(p_k, p_p) and torch.equal(t_k, t_p)
    assert (p_k[active] >= 0).all()
    if not any_hit:
        far = torch.tensor([T - 1, 2 * T - 1], device=dev)
        assert ((t_k[far] - 48.0).abs() < 0.5).all()
        assert ((t_k[active] - 1.0).abs() < 0.01).sum() == T
    if kernel == "intersect" and not any_hit:
        # tile 1's two live rays need at most four chunks (the first
        # plane's, and the far quad's); the build's chunks hold half of two
        # planes each, so the near ray enters about half of them: of its
        # 20-odd visits at least 16 were needed by no ray
        assert v_k[1] >= 20 and n_k[1] <= 4 * ci.CHUNK_ROWS
