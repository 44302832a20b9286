"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(``chip_smoke.py`` makes the same comparisons at the main path's shapes.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from gi_raytracer_tpu_torch import routes
from gi_raytracer_tpu_torch.config import RenderConfig
from gi_raytracer_tpu_torch.ops import _cuda
from gi_raytracer_tpu_torch.ops import cuda_intersect as ci
from gi_raytracer_tpu_torch.ops import cuda_stream as cs
from gi_raytracer_tpu_torch.ops.cuda_megakernel import (mega_info,
                                                        radiance_wave_mega)
from gi_raytracer_tpu_torch.ops.intersect import (chunk_boxes, stream_boxes,
                                                  trace_closest, trace_tables)
from gi_raytracer_tpu_torch.render import Camera, Renderer
from gi_raytracer_tpu_torch.render.geom import normalize
from gi_raytracer_tpu_torch.render.integrator import (_caustic_fold,
                                                      radiance_wave)
from gi_raytracer_tpu_torch.render.photon import (PhotonBatch,
                                                  build_photon_map,
                                                  sample_photons,
                                                  trace_photons)
from gi_raytracer_tpu_torch.render.photon_knn import (COUNTERS, FOCAL,
                                                     _cells, _window,
                                                     knn_counts, knn_info,
                                                     sample_photons_plain,
                                                     sample_photons_tiled)
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


def _half_opaque(dev):
    """A floor, a back wall and a half-opaque sphere (opacity 0.5, ior 1)
    in front of a mirror quad: K1's alpha lottery on closest and any
    hits."""
    b = SceneBuilder()
    white = b.add_texture_const((0.9, 0.9, 0.9))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    wall = b.add_material(white, black, 1.0, 1.0, 1.0)
    b.add_triangles(meshgen.quad_mesh((-4, -1, -4), (4, -1, -4), (-4, -1, 4),
                                      (4, -1, 4)), mat_id=wall)
    b.add_triangles(meshgen.quad_mesh((-4, -1, 4), (4, -1, 4), (-4, 4, 4),
                                      (4, 4, 4)), mat_id=wall)
    v, n, uv = meshgen.sphere_mesh((0.0, 0.2, 0.0), 1.0, 3)
    b.add_triangles(v, n, uv, mat_id=b.add_material(white, black, 1.0, 0.5,
                                                    1.0))
    b.add_triangles(meshgen.quad_mesh((-2, -1, 2), (2, -1, 2), (-2, 2, 2),
                                      (2, 2, 2)),
                    mat_id=b.add_material(white, black, 0.0, 1.0, 1.0))
    b.add_light((0.0, 3.0, -1.0), (8.0, 8.0, 8.0), 0.3)
    return b.build(device=dev)


def _k1_gate(scene, cam, size, cfg, ro=None, rd=None, photon_map=None):
    """K1 against the plain staged wave on one wave of ``size``² lanes:
    lanes within 1e-4 on >= 99.9%, ray counts within 0.05%.  Returns
    (radiance, (n_closest, n_shadow), tests made)."""
    ro_w, rd_w, sx, sy = Renderer(scene, cam, cfg, size, size).wave_inputs(0)
    ro = ro_w if ro is None else ro
    rd = rd_w if rd is None else rd
    lane = torch.arange(ro.shape[0], device=ro.device)
    tests = torch.zeros(2, dtype=torch.int64, device=ro.device)
    rec = (None if photon_map is None else torch.empty(
        (ro.shape[0], cfg.max_depth, 9), device=ro.device))
    before = _cuda.launches["megakernel"]
    got, (gc, gs) = radiance_wave_mega(scene, cfg, ro, rd, sx, sy, lane, 0,
                                       rec, tests=tests)
    assert _cuda.launches["megakernel"] == before + 1
    if rec is not None:          # the caustic term, as dispatch_wave folds it
        got = got + _caustic_fold(photon_map, cfg, rec)
    want, (wc, ws) = radiance_wave(scene, cfg, ro, rd, sx, sy, 0, photon_map,
                                   lane_ids=lane, plain=True)
    assert torch.isfinite(got).all()
    off = ((got - want).abs().max(-1).values > 1e-4).float().mean()
    assert off < 0.001
    assert abs(int(gc) - int(wc)) <= 5e-4 * int(wc)
    assert abs(int(gs) - int(ws)) <= 5e-4 * int(ws)
    # the culled walks test no more than every row for every ray
    t_pad = trace_tables(scene)[0].shape[0]
    assert int(tests[0]) <= int(gc) * t_pad
    assert int(tests[1]) <= int(gs) * t_pad
    return got, (gc, gs), tests


@pytest.mark.parametrize("which", ["cornell", "checker"])
def test_megakernel_matches_plain(dev, scene, which):
    """64x64 lanes, depth 8, no map: lanes within 1e-4 on >= 99.9%, ray
    counts within 0.05%; the Cornell table is walked from shared memory."""
    cfg = RenderConfig(min_samples=1, max_samples=1, adaptive=False,
                       max_depth=8)
    if which == "checker":
        scene = _checker_ball(dev)
        cam = Camera(pos=(0.0, 0.5, -4.0), look_at=(0.0, 0.0, 0.0))
    else:
        cam = Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT)
        assert mega_info(scene)["table_in_smem"] == 1
    _k1_gate(scene, cam, 64, cfg)


def test_megakernel_glass_box_reads_rows_from_device_memory(dev):
    """The 8,342-triangle glass box (66 chunks, a 540,672-byte table past
    a block's shared memory): the walk reads its rows through __ldg."""
    glass = cornell_box(SceneBuilder, meshgen, True, 5).build(device=dev)
    assert glass.n_tris == 8342
    info = mega_info(glass)
    # no spills: the only local memory is the 32-byte buffer of sinf and
    # cosf's argument reduction for huge angles (the shading's are < 2 pi)
    assert info["table_in_smem"] == 0 and info["local_bytes"] <= 32
    cfg = RenderConfig(min_samples=1, max_samples=1, adaptive=False,
                       max_depth=8)
    cam = Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT)
    _, _, tests = _k1_gate(glass, cam, 64, cfg)
    assert int(tests[0]) > 0 and int(tests[1]) > 0


@pytest.mark.parametrize("with_map", [False, True], ids=["no_map", "map"])
@pytest.mark.parametrize("glass_subdivs", [None, 5], ids=["cornell", "glass"])
def test_megakernel_refills_ended_paths(dev, glass_subdivs, with_map):
    """A 320x320 wave, more lanes than the card holds threads at once:
    threads whose paths end take the next lanes from the queue, so warps
    carry paths at different depths (their own samples, caustic record
    slots and outputs), on both branches of the walk."""
    args = () if glass_subdivs is None else (glass_subdivs,)
    scn = cornell_box(SceneBuilder, meshgen, True, *args).build(device=dev)
    cfg = RenderConfig(min_samples=1, max_samples=1, adaptive=False,
                       max_depth=8, photons=50_000)
    info = mega_info(scn)
    assert info["table_in_smem"] == (glass_subdivs is None)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    size = 320
    assert size * size > info["blocks_per_sm"] * info["threads"] * n_sm
    pm = None
    if with_map:
        pm = build_photon_map(trace_photons(scn, cfg),
                              scn.world_min.cpu().numpy(),
                              scn.world_max.cpu().numpy())
    _k1_gate(scn, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT), size, cfg,
             photon_map=pm)


def test_megakernel_half_opaque(dev):
    """The stochastic-alpha lottery (opacity 0.5, ior 1) under the cull,
    on the closest and the shadow walks."""
    soup = _half_opaque(dev)
    assert not soup.all_opaque
    cfg = RenderConfig(min_samples=1, max_samples=1, adaptive=False,
                       max_depth=6)
    _k1_gate(soup, Camera(pos=(0.3, 0.8, -5.0), look_at=(0.0, 0.2, 0.0)),
             64, cfg)


def test_megakernel_every_lane_misses(dev, scene):
    """A wave whose every lane misses at bounce 0 (the rays leave the box
    from outside it): every path ends at once with the ambient term, and
    no shadow ray is cast."""
    cfg = RenderConfig(min_samples=1, max_samples=1, adaptive=False,
                       max_depth=8, ambient=(0.25, 0.5, 0.75))
    cam = Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT)
    ro, rd, _, _ = Renderer(scene, cam, cfg, 64, 64).wave_inputs(0)
    got, (gc, gs), tests = _k1_gate(scene, cam, 64, cfg, ro=ro, rd=-rd)
    assert int(gc) == ro.shape[0] and int(gs) == 0
    assert int(tests[0]) == 0 and int(tests[1]) == 0
    assert torch.equal(got, torch.tensor([[0.25, 0.5, 0.75]], device=dev)
                       .expand_as(got))


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
    want = sample_photons_plain(pm, q, qd, 32)
    assert (got[:16] == 0).all()
    close = ((got - want).abs() <= 1e-6 + 2e-4 * want.abs()).all(-1)
    assert close.float().mean() >= 0.999
    # a query that needs a gradient still takes the kernel forward
    n = _cuda.launches["knn"]
    got_g = sample_photons_tiled(pm, q.clone().requires_grad_(), qd, 32)
    assert _cuda.launches["knn"] == n + 1
    assert torch.equal(got_g.detach(), got) and got_g.requires_grad


def _seeded_map(dev, seed, P=20000, R=4096, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.randn((P, 3), generator=g, device=dev) * 0.3
    d = normalize(torch.randn((P, 3), generator=g, device=dev))
    col = torch.rand((P, 3), generator=g, device=dev)
    pm = build_photon_map(PhotonBatch(
        pos.to(dtype), d.to(dtype), col.to(dtype),
        torch.ones(P, dtype=torch.bool, device=dev)), (-1.5,) * 3, (1.5,) * 3)
    q = (torch.randn((R, 3), generator=g, device=dev) * 0.4).to(dtype)
    qd = normalize(torch.randn((R, 3), generator=g, device=dev)).to(dtype)
    q[:16] = 1e30                               # far sentinels
    return pm, q, qd, torch.randn((R, 3), generator=g, device=dev).to(dtype)


def test_knn_function_grads_with_kernel_forward_equal_plain(dev):
    """The kNN Function (K3 forward, the plain estimator's VJP backward)
    against autograd through the plain forward, on a seeded map: the
    gradients of sum(w * estimate) with respect to the query points and
    directions and the photons' positions, directions and colours agree
    to float32 summation order (rtol 1e-4, atol 1e-6 of the largest)."""
    import dataclasses

    pm, q, qd, w = _seeded_map(dev, 3)

    def grads(fn):
        m = dataclasses.replace(pm, pos=pm.pos.clone().requires_grad_(),
                                dir=pm.dir.clone().requires_grad_(),
                                col=pm.col.clone().requires_grad_())
        qq = q.clone().requires_grad_()
        dd = qd.clone().requires_grad_()
        est = fn(m, qq, dd, 32)
        return torch.autograd.grad((w * est).sum(),
                                   (qq, dd, m.pos, m.dir, m.col))

    n = _cuda.launches["knn"]
    got = grads(sample_photons_tiled)
    assert _cuda.launches["knn"] == n + 1
    want = grads(sample_photons_plain)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        scale = b.abs().max().item()
        assert scale > 0
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * scale)
    assert (got[0][:16] == 0).all()


def test_knn_kernel_follows_an_in_place_map_update(dev):
    """K3 reads a float32 copy of a float64 map, kept on the map: an
    in-place update of the map's colours is seen by the next launch."""
    pm, q, qd, _ = _seeded_map(dev, 4, dtype=torch.float64)
    first = sample_photons_tiled(pm, q, qd, 32)
    pm.col.mul_(2.0)
    second = sample_photons_tiled(pm, q, qd, 32)
    assert (first.abs() > 0).any()
    torch.testing.assert_close(second, 2.0 * first, rtol=1e-6, atol=0.0)


def _knn_ties_included(pm, q, qd, k):
    """The kernel's estimate in plain torch: every photon of the whole
    window with d^2 <= the k-th smallest d^2 counts, ties included (the
    plain ``sample_photons_plain`` takes exactly k)."""
    return _ties_included(pm, q, qd, k)[0]


def _ties_included(pm, q, qd, k):
    """(``_knn_ties_included``, the photons within r_k a query)."""
    occ = int((pm.cell_start[1:] - pm.cell_start[:-1]).max())
    ar = torch.arange(occ, device=q.device)
    idx_l, ok_l = [], []
    for start, end, dup in _window(pm, _cells(pm, q)):
        sl = start[:, None] + ar[None, :]
        idx_l.append(torch.clamp(sl, 0, pm.capacity - 1))
        ok_l.append((sl < end[:, None]) & ~dup[:, None])
    idx, ok = torch.cat(idx_l, 1), torch.cat(ok_l, 1)
    dp = pm.pos[idx] - q[:, None, :]
    d2 = (dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1]) \
        + dp[..., 2] * dp[..., 2]
    d2 = torch.where(ok & pm.valid[idx], d2, torch.inf)
    found = torch.isfinite(d2).sum(1)
    srt = torch.sort(d2, 1).values
    rank = torch.clamp(found, 1, k) - 1
    rk2 = torch.gather(srt, 1, rank[:, None])
    sel = d2 <= rk2
    w = (pm.dir[idx] * qd[:, None, :]).sum(-1)
    total = torch.where(sel[..., None], pm.col[idx] * w[..., None], 0.0) \
        .sum(1)
    est = total / (torch.pi * torch.clamp(rk2, min=1e-20))
    return torch.where((found > 0)[:, None], est, 0.0), sel.sum(1)


def test_knn_kernel_distance_ties(dev):
    """Every photon position held by three photons (other directions and
    colours), so most queries' k-th distance is tied: the kernel counts
    every tied photon, as the TPU kernels do."""
    g = torch.Generator(device=dev).manual_seed(2)
    P = 6000
    pos = (torch.randn((P, 3), generator=g, device=dev) * 0.3).repeat(3, 1)
    d = normalize(torch.randn((3 * P, 3), generator=g, device=dev))
    col = torch.rand((3 * P, 3), generator=g, device=dev)
    pm = build_photon_map(PhotonBatch(pos, d, col, torch.ones(
        3 * P, dtype=torch.bool, device=dev)), (-1.5,) * 3, (1.5,) * 3)
    q = torch.randn((4096, 3), generator=g, device=dev) * 0.4
    qd = normalize(torch.randn((4096, 3), generator=g, device=dev))
    got = sample_photons_tiled(pm, q, qd, 32)
    want = _knn_ties_included(pm, q, qd, 32)
    close = ((got - want).abs() <= 1e-6 + 2e-4 * want.abs()).all(-1)
    assert close.float().mean() >= 0.999
    # the ties matter: the plain estimate (exactly k) differs on many
    plain = sample_photons_plain(pm, q, qd, 32)
    assert ((plain - want).abs() > 1e-6 + 2e-4 * want.abs()).any(-1) \
        .float().mean() > 0.05


def _window_candidates(pm, q):
    cand = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for start, end, dup in _window(pm, _cells(pm, q)):
        cand += torch.where(dup, 0, end - start)
    return cand


def test_knn_kernel_counts_the_whole_window_past_the_cap(dev):
    """A near-coincident focus that no grid splits, as at a caustic's
    focus: the densest cell holds more than the map's window cap (96) and
    windows reach thousands of candidates.  The kernel counts every one,
    as its plain version does; the capped estimator (``knn_backend="jnp"``)
    differs there."""
    g = torch.Generator(device=dev).manual_seed(5)
    pos = torch.cat([torch.randn((20_000, 3), generator=g, device=dev) * 1e-4,
                     torch.rand((30_000, 3), generator=g, device=dev) * 2 - 1])
    P = pos.shape[0]
    up = torch.tensor([0.0, 0.0, 2.0], device=dev)
    pm = build_photon_map(PhotonBatch(
        pos, normalize(torch.randn((P, 3), generator=g, device=dev) + up),
        torch.rand((P, 3), generator=g, device=dev),
        torch.ones(P, dtype=torch.bool, device=dev)), (-1.0,) * 3, (1.0,) * 3)
    assert int((pm.cell_start[1:] - pm.cell_start[:-1]).max()) \
        > pm.window_cap
    q = torch.cat([torch.randn((1024, 3), generator=g, device=dev) * 2e-4,
                   torch.rand((3072, 3), generator=g, device=dev) * 2 - 1])
    qd = normalize(torch.randn((4096, 3), generator=g, device=dev) + up)
    focus = _window_candidates(pm, q) > 2048
    assert focus.sum() >= 1000
    got = sample_photons_tiled(pm, q, qd, 32)
    want = sample_photons_plain(pm, q, qd, 32)
    close = ((got - want).abs() <= 1e-6 + 2e-4 * want.abs()).all(-1)
    assert close.float().mean() >= 0.999
    assert close[focus].float().mean() >= 0.999
    capped = sample_photons(pm, q, qd, 32)
    assert ((capped - want).abs() > 1e-6 + 2e-4 * want.abs()).any(-1)[focus] \
        .float().mean() > 0.5


def test_knn_kernel_windows_past_the_register_store(dev):
    """Windows of several hundred candidates, past the 32 x GI_KNN_REG a
    warp keeps in registers, so the bisection and the sum read the rest
    again from the photon arrays."""
    g = torch.Generator(device=dev).manual_seed(4)
    P = 120_000
    pos = torch.rand((P, 3), generator=g, device=dev) - 0.5
    pm = build_photon_map(PhotonBatch(
        pos, normalize(torch.randn((P, 3), generator=g, device=dev)),
        torch.rand((P, 3), generator=g, device=dev),
        torch.ones(P, dtype=torch.bool, device=dev)),
        (-0.5,) * 3, (0.5,) * 3, target_per_cell=24.0)
    q = torch.rand((4096, 3), generator=g, device=dev) - 0.5
    qd = normalize(torch.randn((4096, 3), generator=g, device=dev))
    cand = _window_candidates(pm, q)
    info = knn_info()
    assert (cand > info["warp"]["register_candidates"]).float().mean() > 0.5
    got = sample_photons_tiled(pm, q, qd, 32)
    want = sample_photons_plain(pm, q, qd, 32)
    close = ((got - want).abs() <= 1e-6 + 2e-4 * want.abs()).all(-1)
    assert close.float().mean() >= 0.999
    assert info["warp"]["local_bytes"] == 0
    assert info["focal"]["local_bytes"] == 0


# the focal tier: queries past the warp tier's threshold, a block each.
# Directions lean to +z (light from above), so the weights dot(dir, qdir)
# are mostly positive and no estimate is a near-cancelling sum whose last
# bits depend on the order of the sum, which differs between the tiers.
def _up_dirs(g, dev, n):
    up = torch.tensor([0.0, 0.0, 2.0], device=dev)
    return normalize(torch.randn((n, 3), generator=g, device=dev) + up)


def _close(got, want):
    return ((got - want).abs() <= 1e-6 + 2e-4 * want.abs()).all(-1)


def _held_to_plain(pm, q, qd, k):
    """K3 against its plain version: returns (close a query, candidates a
    query, queries queued); the kernel queued exactly the live queries
    past FOCAL, its focal grid spent the queue (each block takes one entry
    past its end), and its last block zeroed the live counters."""
    got = sample_photons_tiled(pm, q, qd, k)
    want = sample_photons_plain(pm, q, qd, k)
    cand = _window_candidates(pm, q)
    queued, taken = knn_counts(pm)
    assert queued == int(((cand > FOCAL) & (q[:, 0] < 1e29)).sum())
    assert taken == queued + knn_info()["focal"]["grid"]
    assert pm.__dict__["_knn_scratch"][:3].tolist() == [0, 0, 0]
    return _close(got, want), cand, queued


def test_knn_tiers_meet_at_the_threshold(dev):
    """Uniform photons whose windows hold about FOCAL candidates (grid
    cells of FOCAL / 27): windows of exactly FOCAL candidates stay on the
    warp tier, those of FOCAL + 1 go to the focal tier, and both agree
    with the plain version."""
    focal = FOCAL
    g = torch.Generator(device=dev).manual_seed(20 + focal)
    # a 16^3 grid (4,000 cells asked for: the map pads the photons' extent
    # by 1e-3 a side) of about focal / 27 photons a cell
    P = 151 * focal
    pos = torch.rand((P, 3), generator=g, device=dev) - 0.5
    pm = build_photon_map(PhotonBatch(
        pos, _up_dirs(g, dev, P), torch.rand((P, 3), generator=g, device=dev),
        torch.ones(P, dtype=torch.bool, device=dev)),
        (-0.5,) * 3, (0.5,) * 3, target_per_cell=P / 4000, window_cap=96)
    assert pm.dims == (16, 16, 16)
    q = (torch.rand((8192, 3), generator=g, device=dev) - 0.5) * 0.9
    close, cand, queued = _held_to_plain(pm, q, _up_dirs(g, dev, 8192), 32)
    at, past = cand == focal, cand == focal + 1
    assert at.any() and past.any() and 0 < queued < q.shape[0]
    assert close[at].all() and close[past].all()
    assert close.float().mean() >= 0.999


@pytest.fixture(scope="module")
def focal_map(dev):
    """A near-coincident blob of more photons than a focal block stages in
    shared memory (no grid of the map's cell budget splits it) in a sparse
    background; queries inside the blob (focal, past the capacity) and
    over the box (short windows)."""
    g = torch.Generator(device=dev).manual_seed(21)
    n_blob = knn_info()["staged_capacity"] + 12_000
    at = torch.tensor([0.1, 0.05, -0.1], device=dev)
    pos = torch.cat([at + 1e-4 * torch.randn((n_blob, 3), generator=g,
                                             device=dev),
                     torch.rand((20_000, 3), generator=g, device=dev) * 2 - 1])
    P = pos.shape[0]
    pm = build_photon_map(PhotonBatch(
        pos, _up_dirs(g, dev, P), torch.rand((P, 3), generator=g, device=dev),
        torch.ones(P, dtype=torch.bool, device=dev)), (-1.0,) * 3,
        (1.0,) * 3, max_cells=1 << 18)
    focus = at + 2e-4 * torch.randn((256, 3), generator=g, device=dev)
    spread = torch.rand((1024, 3), generator=g, device=dev) * 2 - 1
    return pm, focus, spread, _up_dirs(g, dev, 1280)


def test_knn_focal_tier_past_shared_capacity(dev, focal_map):
    """Windows past a focal block's shared memory: the same radix passes
    over distances computed again from device memory, in the same launch."""
    pm, focus, spread, qd = focal_map
    q = torch.cat([focus, spread])
    close, cand, queued = _held_to_plain(pm, q, qd, 32)
    assert (cand > knn_info()["staged_capacity"]).sum() >= 200
    assert queued >= 256
    assert close.float().mean() >= 0.999
    assert close[:256].float().mean() >= 0.999


def test_knn_batches_of_one_tier(dev, focal_map):
    """A batch with no focal query (the focal grid reads a zero count and
    ends) and a batch of focal queries only; then the same call again,
    with its queue counter zeroed by the last call's focal grid, gives the
    same bits and counts."""
    pm, focus, spread, qd = focal_map
    short = spread[_window_candidates(pm, spread) <= FOCAL]
    close, _, queued = _held_to_plain(pm, short, qd[:short.shape[0]], 32)
    assert queued == 0 and close.float().mean() >= 0.999
    close, _, queued = _held_to_plain(pm, focus, qd[:256], 32)
    assert queued == 256 and close.all()
    first = sample_photons_tiled(pm, focus, qd[:256], 32)
    c1 = knn_counts(pm)
    again = sample_photons_tiled(pm, focus, qd[:256], 32)
    assert torch.equal(first, again) and knn_counts(pm) == c1


@pytest.mark.parametrize("k", [1, 64])
def test_knn_focal_tier_k_bounds(dev, focal_map, k):
    """k = 1 and k = KMAX on the focal tier, staged and past the capacity."""
    pm, focus, spread, qd = focal_map
    q = torch.cat([focus, spread])
    close, _, queued = _held_to_plain(pm, q, qd, k)
    assert queued >= 256
    assert close[:256].all() and close.float().mean() >= 0.999


def test_knn_focal_tier_distance_ties(dev):
    """A blob whose every position is held by three photons, with windows
    past the threshold: the focal tier counts every tied photon."""
    g = torch.Generator(device=dev).manual_seed(22)
    at = torch.tensor([-0.2, 0.1, 0.05], device=dev)
    blob = (at + 1e-3 * torch.randn((1500, 3), generator=g, device=dev)) \
        .repeat(3, 1)
    pos = torch.cat([blob, torch.rand((4000, 3), generator=g, device=dev)
                     * 2 - 1])
    P = pos.shape[0]
    pm = build_photon_map(PhotonBatch(
        pos, _up_dirs(g, dev, P), torch.rand((P, 3), generator=g, device=dev),
        torch.ones(P, dtype=torch.bool, device=dev)), (-1.0,) * 3,
        (1.0,) * 3, max_cells=1 << 18)
    q = at + 1e-3 * torch.randn((256, 3), generator=g, device=dev)
    qd = _up_dirs(g, dev, 256)
    got = sample_photons_tiled(pm, q, qd, 32)
    queued = knn_counts(pm)[0]
    assert queued == int((_window_candidates(pm, q) > FOCAL).sum())
    assert queued >= 200
    want = _knn_ties_included(pm, q, qd, 32)
    assert _close(got, want).float().mean() >= 0.999
    # the ties matter: the plain estimate (exactly k) differs on many
    plain = sample_photons_plain(pm, q, qd, 32)
    assert (~_close(plain, want)).float().mean() > 0.05


def test_knn_info_both_tiers(dev):
    """Neither tier spills; the warp tier's threshold is the window its
    registers hold; a focal block stages its dynamic shared memory's worth
    of d^2 bits, on a grid of the SMs times its resident blocks."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    info = knn_info()
    assert info["focal_threshold"] == FOCAL
    assert info["warp"]["register_candidates"] == FOCAL
    assert info["counters"] == COUNTERS
    assert info["warp"]["local_bytes"] == 0
    assert info["focal"]["local_bytes"] == 0
    assert info["warp"]["blocks_per_sm"] >= 1
    assert info["focal"]["blocks_per_sm"] >= 1
    assert info["focal"]["grid"] == sms * info["focal"]["blocks_per_sm"]
    assert info["staged_capacity"] == info["focal"]["dynamic_smem"] // 4
    assert info["staged_capacity"] > 4 * FOCAL


def _ties_included_bounded(pm, q, qd, k, chunk=16):
    """(``_knn_ties_included``, its float32 rounding bound, the sum's
    magnitude), channel by channel, ``chunk`` queries at a time.  A sum of
    n products in any order lies within gamma_n sum |product| of the exact
    sum (gamma_n = n u / (1 - n u), u = 2^-24), so two sums of it differ by
    at most 2 gamma_(n+3) times the magnitude, sum |col| sum_c |dir_c
    qdir_c| over the n photons within r_k (ties included; the 3 for the
    weight's dot product) over pi r_k^2: the estimate of the map and query
    directions with every component's absolute value."""
    abs_pm = dataclasses.replace(pm, dir=pm.dir.abs(), col=pm.col.abs())
    u = 2.0 ** -24
    est, bound, mags = [], [], []
    for i in range(0, q.shape[0], chunk):
        e, n = _ties_included(pm, q[i:i + chunk], qd[i:i + chunk], k)
        mag = _knn_ties_included(abs_pm, q[i:i + chunk],
                                 qd[i:i + chunk].abs(), k)
        n = n.double()[:, None] + 3
        est.append(e)
        bound.append(2 * n * u / (1 - n * u) * mag)
        mags.append(mag)
    return torch.cat(est), torch.cat(bound), torch.cat(mags)


def test_knn_isotropic_directions_within_rounding(dev):
    """Photon and query directions drawn over the whole sphere, so that
    some estimates are near-cancelling sums, on windows of every tier (the
    warp tier, the focal tier staged and past the staged capacity): every
    query agrees with the plain version within the K3 tolerance plus the
    float32 rounding bound of its sum, the only place where the block's
    summation order may show."""
    g = torch.Generator(device=dev).manual_seed(23)
    n_blob = knn_info()["staged_capacity"] + 12_000
    at = torch.tensor([0.1, 0.05, -0.1], device=dev)
    mid = torch.tensor([-0.5, 0.4, 0.3], device=dev)
    pos = torch.cat([at + 1e-4 * torch.randn((n_blob, 3), generator=g,
                                             device=dev),
                     mid + 1e-3 * torch.randn((4000, 3), generator=g,
                                              device=dev),
                     torch.rand((20_000, 3), generator=g, device=dev) * 2 - 1])
    P = pos.shape[0]
    pm = build_photon_map(PhotonBatch(
        pos, normalize(torch.randn((P, 3), generator=g, device=dev)),
        torch.rand((P, 3), generator=g, device=dev),
        torch.ones(P, dtype=torch.bool, device=dev)), (-1.0,) * 3,
        (1.0,) * 3, max_cells=1 << 18)
    q = torch.cat([at + 2e-4 * torch.randn((64, 3), generator=g, device=dev),
                   mid + 2e-3 * torch.randn((256, 3), generator=g,
                                            device=dev),
                   torch.rand((1024, 3), generator=g, device=dev) * 2 - 1])
    qd = normalize(torch.randn((q.shape[0], 3), generator=g, device=dev))
    got = sample_photons_tiled(pm, q, qd, 32)
    cand = _window_candidates(pm, q)
    cap = knn_info()["staged_capacity"]
    assert (cand <= FOCAL).any() and (cand > cap).sum() >= 32
    assert ((cand > FOCAL) & (cand <= cap)).sum() >= 128
    want, bound, mag = _ties_included_bounded(pm, q, qd, 32)
    err = (got - want).abs()
    assert (err <= 1e-6 + 2e-4 * want.abs() + bound).all()
    # some focal sums cancel to below 1% of their magnitude, where the
    # sums' rounding reaches the 2e-4 tolerance
    cancel = want.abs() < 1e-2 * mag
    assert (cancel & (cand > FOCAL)[:, None]).sum() >= 4


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


def test_megakernel_on_block_compacted_lane_ids(dev, scene):
    """K1 on a wave of the 16x16 blocks of a 128x128 frame taken with gaps
    (every third block and the last), whose lane ids are not contiguous,
    against the plain staged wave on the same lanes; and each lane equals
    the same lane of the full-frame wave (a lane's path follows its id,
    not its slot)."""
    cfg = RenderConfig(min_samples=8, max_samples=32, max_depth=8)
    r = Renderer(scene, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT), cfg,
                 128, 128)
    assert r.block_adaptive
    wave, N = 3, 128 * 128
    blocks = torch.cat([torch.arange(0, 63, 3, device=dev),
                        torch.tensor([63], device=dev)])
    pos = (blocks[:, None] * 256 + torch.arange(256, device=dev)).reshape(-1)
    ro, rd, sx, sy = r.wave_inputs(wave, pos)
    lane = wave * N + pos
    before = _cuda.launches["megakernel"]
    got, (gc, gs) = radiance_wave_mega(scene, cfg, ro, rd, sx, sy, lane, 0)
    assert _cuda.launches["megakernel"] == before + 1
    want, (wc, ws) = radiance_wave(scene, cfg, ro, rd, sx, sy, 0,
                                   lane_ids=lane, plain=True)
    off = ((got - want).abs().max(-1).values > 1e-4).float().mean()
    assert off < 0.001
    assert abs(int(gc) - int(wc)) <= 5e-4 * int(wc)
    assert abs(int(gs) - int(ws)) <= 5e-4 * int(ws)
    ro_f, rd_f, sx_f, sy_f = r.wave_inputs(wave)
    full, _ = radiance_wave_mega(scene, cfg, ro_f, rd_f, sx_f, sy_f,
                                 wave * N + torch.arange(N, device=dev), 0)
    assert torch.equal(got, full[pos])
    img, rays = r.block_wave(wave, blocks)
    assert torch.equal(img.reshape(-1, 3)[r._perm_t[pos]], got)
    assert int(rays) == int(gc) + int(gs)


def test_trace_kernel_with_a_sphere_touching_a_wall(dev):
    """K2 plus the sphere pass on rays grazing the seam where an analytic
    sphere sinks 0.05 into the floor (the analytic Cornell box): the
    kernel's trace against the plain walk's, prim ids equal on >= 99.9%
    of lanes, and the sphere wins many of them."""
    an = cornell_box(SceneBuilder, meshgen, True, analytic=True).build(
        device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    R = 65536
    # points on the seam circle (the floor y = -4 cuts the glass sphere)
    ang = torch.rand(R, generator=g, device=dev) * 2 * torch.pi
    rad = (1.2 ** 2 - 1.15 ** 2) ** 0.5
    seam = torch.stack([-1.4 + rad * torch.cos(ang),
                        torch.full_like(ang, -4.0),
                        -0.6 + rad * torch.sin(ang)], 1)
    ro = (torch.rand((R, 3), generator=g, device=dev) * 2 - 1) * 3.5
    tgt = seam + torch.randn((R, 3), generator=g, device=dev) * 0.02
    rd = normalize(tgt - ro)
    rid = torch.arange(R, device=dev) * 5 + 7
    before = _cuda.launches["intersect"]
    hit_k = trace_closest(an, ro, rd, salt=99, ray_id=rid)
    assert _cuda.launches["intersect"] == before + 1
    hit_p = trace_closest(an, ro, rd, salt=99, ray_id=rid, plain=True)
    sphere = hit_p.prim == an.n_tris
    assert sphere.float().mean() > 0.2
    assert (hit_k.prim == hit_p.prim).float().mean() >= 0.999
    both = (hit_k.prim >= 0) & (hit_p.prim >= 0)
    assert ((hit_k.t - hit_p.t).abs() <= 1e-5 * hit_p.t.abs())[both] \
        .float().mean() >= 0.999


def test_fog_march_matches_its_step_loop(dev):
    """The blocked fog march on a 512x512-lane batch of the fog Cornell
    box against the plain step-by-step loop: scatter flags and t equal."""
    from gi_raytracer_tpu_torch.render import atmosphere as atm

    b = cornell_box(SceneBuilder, meshgen, True)
    b.add_height_fog((4.0, 3.4, 0.0), (16.0, 8.0, 8.4), (1.0, 1.0, 1.0),
                     0.05, 0.5, 2)
    fog = b.build(device=dev)
    cfg = RenderConfig(max_depth=6)
    ro, rd, _, _ = Renderer(fog, Camera(pos=CAMERA_POS,
                                        look_at=CAMERA_LOOK_AT), cfg,
                            512, 512).wave_inputs(0)
    hit = trace_closest(fog, ro, rd)
    t_cap = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    tmin, tmax, has = atm._fog_bounds(fog, ro, rd, t_cap)
    lane = 7 * 262144 + torch.arange(ro.shape[0], device=dev)
    got = atm._march(fog, cfg, ro, rd, tmin, tmax, has, 31337, ray_id=lane)
    want = atm._march_steps(fog, cfg, ro, rd, tmin, tmax, has, 31337,
                            ray_id=lane)
    # the light fog scatters about 1.5% of the primary rays before the
    # surface (3,800 lanes)
    assert 1000 < int(want[0].sum()) < ro.shape[0] // 2
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def _fog_box(dev, density):
    """The fog cell's Cornell box and fog, at ``density``, on the card."""
    b = cornell_box(SceneBuilder, meshgen, True)
    b.add_height_fog((4.0, 3.4, 0.0), (16.0, 8.0, 8.4), (1.0, 1.0, 1.0),
                     density, 0.5, 2)
    return b.build(device=dev)


@pytest.fixture(scope="module", params=[0.05, 2.0],
                ids=["cell_density", "dense"])
def fog_batch(dev, request):
    """The 512x512 primary batch of ``test_fog_march_matches_its_step_loop``
    in the fog box at the cell's density (0.05) and at 2.0 (lanes scatter
    in every block): (scene, config, the march's arguments)."""
    from gi_raytracer_tpu_torch.render import atmosphere as atm

    fog = _fog_box(dev, request.param)
    cfg = RenderConfig(max_depth=6)
    ro, rd, _, _ = Renderer(fog, Camera(pos=CAMERA_POS,
                                        look_at=CAMERA_LOOK_AT), cfg,
                            512, 512).wave_inputs(0)
    hit = trace_closest(fog, ro, rd)
    t_cap = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    tmin, tmax, has = atm._fog_bounds(fog, ro, rd, t_cap)
    lane = 7 * 262144 + torch.arange(ro.shape[0], device=dev)
    return fog, cfg, (ro, rd, tmin, tmax, has, 31337), lane


def test_fog_march_kernel_matches_the_torch_route(dev, fog_batch):
    """The march's kernel route, one launch, against the blocked march and
    the step loop: scatter flags and t_hit bit-equal."""
    from gi_raytracer_tpu_torch.render import atmosphere as atm

    fog, cfg, args, lane = fog_batch
    assert routes.fog_march(fog, cfg, args[0], args[1]) == ("kernel", [])
    n0 = _cuda.launches["fog_march"]
    got = atm.march(fog, cfg, *args, ray_id=lane)
    assert _cuda.launches["fog_march"] == n0 + 1
    assert int(got[0].sum()) > 1000
    for want in (atm._march(fog, cfg, *args, ray_id=lane),
                 atm._march_steps(fog, cfg, *args, ray_id=lane)):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))


def _march_spans(fn):
    """``fn()`` under a profiler of the device, and its ``fog.march``
    spans' (use, route, lanes, blocks, lane_steps)."""
    from torch.profiler import ProfilerActivity, profile

    from gi_raytracer_tpu_torch import telemetry
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CUDA]):
        out = fn()
        torch.cuda.synchronize()
    spans = [tuple(sp.attrs[k] for k in ("use", "route", "lanes", "blocks",
                                         "lane_steps"))
             for sp in telemetry.records() if sp.name == "fog.march"]
    telemetry.reset()
    return out, spans


def test_fog_march_kernel_counts_as_the_blocked_march(dev, fog_batch):
    """On the kernel's route the ``fog.march`` span's ``lanes``, ``blocks``
    and ``lane_steps``, counted on the card into pinned memory, equal the
    blocked march's on the same inputs; off the profiler the kernel
    counts nothing."""
    from gi_raytracer_tpu_torch.render import atmosphere as atm

    fog, cfg, args, lane = fog_batch
    _, (got,) = _march_spans(lambda: atm.march(fog, cfg, *args,
                                               ray_id=lane))
    _, (want,) = _march_spans(lambda: atm._march(fog, cfg, *args,
                                                 ray_id=lane))
    assert got[1:2] == ("kernel",) and want[1:2] == ("torch",)
    assert got[2:] == want[2:] and want[4] > 0
    atm.march(fog, cfg, *args, ray_id=lane)
    _, (again,) = _march_spans(lambda: atm.march(fog, cfg, *args,
                                                 ray_id=lane))
    assert again == got


@pytest.mark.parametrize("case", ["no_lane", "100_steps", "active",
                                  "grid_past_1"])
def test_fog_march_kernel_edge_cases(dev, case):
    """The kernel's route against the blocked march on rays through the
    dense fog, found, t_hit and the span's counts: a march no lane
    enters, ``raymarch_max_steps`` not a multiple of 32,
    ``fog_occludes``/``fog_override`` with an ``active`` mask, and the
    cell's density over a grid of values in [-0.2, 1.2) (the density's
    clamps and pow on values past the noise's [0, 1))."""
    from gi_raytracer_tpu_torch.render import atmosphere as atm

    fog = _fog_box(dev, 0.05 if case == "grid_past_1" else 2.0)
    if case == "grid_past_1":
        fog = dataclasses.replace(fog, fog=dataclasses.replace(
            fog.fog, grid=fog.fog.grid * 1.4 - 0.2))
    cfg = RenderConfig(max_depth=6)
    ro, rd = _random_rays(dev, 65536, 3)
    ro = ro * 0.9
    tmin, tmax, has = atm._fog_bounds(fog, ro, rd,
                                      torch.full((65536,), 12.0, device=dev))
    lane = torch.arange(65536, device=dev) * 3
    if case == "no_lane":
        has = torch.zeros_like(has)
    if case == "100_steps":
        cfg = cfg.replace(raymarch_max_steps=100)
    if case != "active":
        args = (ro, rd, tmin, tmax, has, 99)
        got, g_spans = _march_spans(lambda: atm.march(fog, cfg, *args,
                                                      ray_id=lane))
        want, w_spans = _march_spans(lambda: atm._march(fog, cfg, *args,
                                                        ray_id=lane))
        assert [s[2:] for s in g_spans] == [s[2:] for s in w_spans]
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))
        assert (int(got[0].sum()) == 0) == (case == "no_lane")
        return
    active = torch.rand(65536, generator=torch.Generator(device=dev)
                        .manual_seed(4), device=dev) < 0.5
    t_hit = torch.where(torch.rand(65536, device=dev) < 0.2, torch.inf,
                        torch.full((65536,), 9.0, device=dev))
    z = torch.zeros((65536, 3), device=dev)
    zs = torch.zeros(65536, device=dev)
    calls = (lambda: atm.fog_occludes(fog, cfg, ro, rd, tmax, 77,
                                      ray_id=lane, active=active),
             lambda: atm.fog_override(fog, cfg, ro, rd, t_hit, zs + 0.3,
                                      zs + 0.6, 78, z, z, z, z, z, z, zs,
                                      zs, ray_id=lane, active=active))
    for k, call in enumerate(calls):
        got = call()
        orig = routes.fog_march
        routes.fog_march = lambda *a: ("torch", ["forced"])
        try:
            want = call()
        finally:
            routes.fog_march = orig
        if not k:   # some shadow rays of the active lanes occluded
            assert bool(got.any()) and not bool((got & ~active).any())
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_fog_march_kernel_once_a_march(dev):
    """A fog frame on the card marches every bounce and shadow ray by one
    launch of the kernel: as many launches as ``fog.march`` spans, each
    on the kernel's route, and no call of the blocked march."""
    fog = _fog_box(dev, 0.05)
    r = Renderer(fog, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT),
                 RenderConfig(adaptive=False, min_samples=2, max_samples=2,
                              max_depth=3, ambient=(0.35, 0.35, 0.35)),
                 64, 64)
    r.render()
    torch.cuda.synchronize(dev)
    _cuda.reset_launches()
    _, spans = _march_spans(r.render)
    assert len(spans) == _cuda.launches["fog_march"] > 0
    assert {s[1] for s in spans} == {"kernel"}
    assert _cuda.plain_calls["fog_march"] == 0


# ---- the program's spans and counters on the card (telemetry) -----------

def _device_events(prof):
    """(name, start_ns, end_ns) of the profiler's device events."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def test_telemetry_shares_the_profilers_clock(dev):
    """Under the benchmark's profiler (the device alone), a kernel that a
    span enqueues and waits for runs inside that span, and a span closed
    before the launch ends before the kernel starts: the spans' stamps
    and the device events' are on one clock."""
    from torch.profiler import ProfilerActivity, profile

    from gi_raytracer_tpu_torch import telemetry
    telemetry.reset()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with telemetry.span("before"):
            pass
        with telemetry.span("sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize(dev)
    spans = {sp.name: sp for sp in telemetry.records()}
    (name, start, end), = [e for e in _device_events(prof)]
    assert spans["sleep"].start_ns <= start < end <= spans["sleep"].end_ns, (
        name, spans["sleep"], start, end)
    assert spans["before"].end_ns <= start
    telemetry.reset()


@pytest.fixture(scope="module")
def chunk_map(dev, scene):
    """A 131,072-slot photon batch (one chunk) of the Cornell box and its
    map."""
    cfg = RenderConfig(photons=131_072, ray_chunk=131_072, seed=11)
    batch = trace_photons(scene, cfg)
    return batch, build_photon_map(batch, scene.world_min.cpu().numpy(),
                                   scene.world_max.cpu().numpy())


def _sync_jobs(dev, scene, chunk_map):
    """The jobs of every cell's kind, small: a frame of the render_map
    traffic (K1, K3) and of the terrain's (staged wave, K4) at 64x64, a
    photon chunk and its map, a train step at 32x32, and a frame of the
    fog box (the fog march's waits) at 64x64."""
    from gi_raytracer_tpu_torch.train import TrainStep

    batch, pm = chunk_map
    cam = Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT)
    base = dict(adaptive=False, knn_k=32, seed=5)
    r_map = Renderer(scene, cam, RenderConfig(min_samples=8, max_samples=8,
                                              max_depth=8, **base),
                     64, 64, photon_map=pm)
    ter = terrain_scene(SceneBuilder, 120).build(device=dev)
    r_ter = Renderer(ter, Camera(pos=(0.0, 18.0, -30.0),
                                 look_at=(0.0, 0.0, 0.0)),
                     RenderConfig(min_samples=2, max_samples=2, max_depth=3,
                                  **base), 64, 64)
    pcfg = RenderConfig(photons=131_072, ray_chunk=131_072, seed=12)
    wmin = scene.world_min.cpu().numpy()
    wmax = scene.world_max.cpu().numpy()
    step = TrainStep(scene, cam, RenderConfig(seed=5), batch, size=32,
                     depth=8, photons=50_000)
    fb = cornell_box(SceneBuilder, meshgen, True)
    # the cell's fog, denser: lanes scatter in every block of the march
    fb.add_height_fog((4.0, 3.4, 0.0), (16.0, 8.0, 8.4), (1.0, 1.0, 1.0),
                      2.0, 0.5, 2)
    r_fog = Renderer(fb.build(device=dev), cam,
                     RenderConfig(min_samples=2, max_samples=2, max_depth=3,
                                  ambient=(0.35, 0.35, 0.35), **base),
                     64, 64)
    return {"render_map": r_map.render, "terrain": r_ter.render,
            "photon_chunk": lambda: build_photon_map(
                trace_photons(scene, pcfg), wmin, wmax),
            "train_step": step, "fog": r_fog.render}


def test_telemetry_marks_every_sync(dev, scene, chunk_map):
    """With recording on (a profiler of the device) and torch's sync debug
    mode at "warn", each job's synchronizing operations are exactly its
    ``sync`` spans: each warning is raised while a ``sync`` span is the
    innermost one open, and there is one warning a span."""
    import collections
    import os
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from gi_raytracer_tpu_torch import telemetry
    for name, job in _sync_jobs(dev, scene, chunk_map).items():
        job()                   # tables and caches, as set-up builds them
        torch.cuda.synchronize(dev)
        telemetry.reset()
        caught = []             # (where, the innermost open span's name)

        def note(message, category, filename, lineno, file=None,
                 line=None):
            if "called a synchronizing CUDA operation" in str(message):
                top = telemetry._rec.open[-1:]
                caught.append((f"{os.path.basename(filename)}:{lineno}",
                               top[0].name if top else None))

        with profile(activities=[ProfilerActivity.CUDA]):
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = note
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    job()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize(dev)
        unmarked = sorted({w for w, top in caught if top != "sync"})
        assert not unmarked, (name, unmarked)
        recs = telemetry.records()
        spans = collections.Counter(sp.attrs["site"] for sp in recs
                                    if sp.name == "sync")
        if name == "fog":
            # the march's kernel waits for nothing
            assert not {"fog.block", "fog.lanes"} & set(spans), spans
            assert {sp.attrs["route"] for sp in recs
                    if sp.name == "fog.march"} == {"kernel"}
        assert len(caught) == sum(spans.values()) > 0, (
            name, sorted(collections.Counter(w for w, _ in caught).items()),
            sorted(spans.items()))
    telemetry.reset()


def test_telemetry_k3_totals_sum_the_calls_counts(dev, scene, chunk_map):
    """While recording, K3 adds each launch's queued and taken counts to
    the totals: over a render with the map they equal the sum of
    ``knn_counts`` read after each call, and the calls launch K3's two
    kernels and nothing more."""
    from torch.profiler import ProfilerActivity, profile

    from gi_raytracer_tpu_torch import telemetry
    from gi_raytracer_tpu_torch.render import photon_knn

    _, pm = chunk_map
    r = Renderer(scene, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT),
                 RenderConfig(adaptive=False, min_samples=2, max_samples=2,
                              max_depth=8, knn_k=32, seed=5),
                 128, 128, photon_map=pm)
    r.render()
    orig, sums = photon_knn._knn_cuda, [0, 0, 0]

    def counted(*a):
        out = orig(*a)
        q, t = knn_counts(pm)
        sums[0] += q
        sums[1] += t
        sums[2] += 1
        return out

    photon_knn._knn_cuda = counted
    try:
        torch.cuda.synchronize(dev)
        telemetry.reset()
        before = _cuda.launches["knn"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            r.render()
            torch.cuda.synchronize(dev)
    finally:
        photon_knn._knn_cuda = orig
    assert telemetry.k3_counts() == (sums[0], sums[1])
    assert sums[0] > 0 and sums[2] > 0
    assert _cuda.launches["knn"] - before == sums[2]
    knn = [n for n, _, _ in _device_events(prof) if "gi_knn" in n]
    assert len(knn) == 2 * sums[2]
    calls = [sp for sp in telemetry.records() if sp.name == "knn"]
    assert len(calls) == sums[2]
    # off the profiler the kernel adds nothing to them
    r.render()
    torch.cuda.synchronize(dev)
    assert telemetry.k3_counts() == (sums[0], sums[1])
    telemetry.reset()


# the photon cell's bound on a stored photon's position (gibench's
# PHOTON_POS_TOL): a last-bit difference between the round kernel and the
# staged round must stay under it
PHOTON_POS_TOL = 1e-3


def _chunk_rounds(scene, cfg, chunk, n, total, light):
    """``_emit_chunk`` of chunk ``chunk`` (n slots of a ``total``-slot map)
    on the round kernel (``light``: the light's constants) or the staged
    round (None): (batch, each round's live count, launches, plain calls).
    The rounds' spans are recorded under a profiler of the device."""
    from torch.profiler import ProfilerActivity, profile

    from gi_raytracer_tpu_torch import telemetry
    from gi_raytracer_tpu_torch.render import photon
    from gi_raytracer_tpu_torch.sampling.halton import HaltonSampler

    uniform = photon.ThreefryUniform(cfg.seed, scene.device)
    start = chunk * cfg.ray_chunk
    torch.cuda.synchronize()
    telemetry.reset()
    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]):
        b = photon._emit_chunk(scene, cfg, HaltonSampler(), uniform, chunk,
                               start, 0, n, total, False, light)
    torch.cuda.synchronize()
    rounds = [sp for sp in telemetry.records() if sp.name == "photons.round"]
    assert {sp.attrs["route"] for sp in rounds} == {
        "staged" if light is None else "k2"}
    telemetry.reset()
    return (b, [sp.attrs["live"] for sp in rounds],
            {k: v for k, v in _cuda.launches.items() if v},
            {k: v for k, v in _cuda.plain_calls.items() if v})


@pytest.mark.parametrize("chunk, n", [(0, 131_072), (5, 94_640)],
                         ids=["full", "ragged"])
def test_photon_round_kernel_matches_staged(dev, scene, chunk, n):
    """The round kernel against the staged round on the Cornell box, on a
    chunk of the 750,000-slot map (its first 131,072 slots; its last,
    ragged 94,640), through all 64 rounds: the same live count each round,
    stored masks equal bit for bit, positions, directions and colours
    equal or, where a last bit differs, within the cell's position bound
    (the largest difference and its lanes printed); one launch a round,
    no plain version."""
    from gi_raytracer_tpu_torch.ops import cuda_photon
    from gi_raytracer_tpu_torch.render import photon

    cfg = RenderConfig(photons=750_000, seed=2876543219)
    assert routes.photon_round(scene, cfg, None, None, False) == ("k2", [])
    got, got_live, launches, plain = _chunk_rounds(
        scene, cfg, chunk, n, 750_000, photon._light_row(scene, 0, 750_000))
    want, want_live, _, _ = _chunk_rounds(scene, cfg, chunk, n, 750_000,
                                          None)
    print(f"\nround kernel {cuda_photon.round_info(scene)}; K2 "
          f"{ci.walk_info('intersect', chunk_boxes(scene).shape[1])}")
    print(f"chunk {chunk}: {len(got_live)} rounds, live {got_live[:4]}..."
          f"{got_live[-2:]}, {int(got.stored.sum())} of {n} stored")
    _rounds_match(got, got_live, launches, plain, want, want_live)


def _rounds_match(got, got_live, launches, plain, want, want_live):
    """The round kernel's chunk (``_chunk_rounds``) against the staged
    round's: the same live count each round, one launch a round and no
    plain version, stored masks equal bit for bit, positions, directions
    and colours equal or, where a last bit differs, within the cell's
    position bound (the largest difference and its lanes printed)."""
    assert got_live == want_live
    assert launches == {"photon_round": len(got_live)} and not plain
    assert torch.equal(got.stored, want.stored)
    for name in ("pos", "dir", "col"):
        a, b = getattr(got, name), getattr(want, name)
        off = (a != b).any(-1).nonzero().squeeze(1)
        diff = float((a - b).abs().max())
        print(f"{name}: {off.numel()} lanes differ, largest {diff:.3e}, "
              f"lanes {off[:8].tolist()}")
        assert diff <= PHOTON_POS_TOL, (name, diff, off[:8].tolist())


def _glossy_box(dev):
    """A triangle-only scene whose photons take the branches of the round
    that the Cornell box leaves out: a glossy sphere (roughness 0.05: a
    Phong lobe inside the specular chain) and a glossy floor (0.3: a Phong
    lobe where the photon is stored), each with a checker texture read at
    its vertex-interpolated uv, beside a mirror sphere with the floor's
    checker and a diffuse back wall without vertex normals."""
    b = SceneBuilder()
    black = b.add_texture_const((0.0, 0.0, 0.0))
    floor_tex = b.add_texture_checker(4, (0.8, 0.8, 0.2), (0.2, 0.8, 0.8))
    ball_tex = b.add_texture_checker(6, (0.9, 0.5, 0.5), (0.5, 0.9, 0.5))
    s = 4.0
    floor = meshgen.quad_mesh((-s, -s, -s), (s, -s, -s), (-s, -s, s),
                              (s, -s, s))
    up = np.broadcast_to(np.array([0.0, 1.0, 0.0]), floor.shape)
    b.add_triangles(floor, up, (floor[..., [0, 2]] + s) / (2 * s),
                    mat_id=b.add_material(floor_tex, black, 0.3, 1.0))
    wall = b.add_material(b.add_texture_const((0.7, 0.7, 0.7)), black, 1.0,
                          1.0)
    b.add_triangles(meshgen.quad_mesh((-s, -s, s), (s, -s, s), (-s, s, s),
                                      (s, s, s)), mat_id=wall)
    v, n, uv = meshgen.sphere_mesh((-1.2, -2.6, 0.0), 1.3, 3)
    b.add_triangles(v, n, uv,
                    mat_id=b.add_material(ball_tex, black, 0.05, 1.0))
    v, n, uv = meshgen.sphere_mesh((1.6, -3.0, 0.8), 0.9, 2)
    b.add_triangles(v, n, uv,
                    mat_id=b.add_material(floor_tex, black, 0.0, 1.0))
    b.add_light((0.0, 3.0, 0.0), (8.0, 8.0, 8.0), 0.3)
    return b.build(device=dev)


def test_photon_round_kernel_matches_staged_glossy_checker(dev):
    """The round kernel against the staged round through every round of
    the second 32,768-slot chunk of a 65,536-slot map of ``_glossy_box``,
    held as on the Cornell box (``_rounds_match``); the stored photons
    show the glossy and checker branches taken (a quarter or more lie on
    the glossy floor, and their colours are many products of the
    checkers')."""
    from gi_raytracer_tpu_torch.render import photon

    box = _glossy_box(dev)
    cfg = RenderConfig(photons=65_536, ray_chunk=32_768, seed=3141592653)
    assert routes.photon_round(box, cfg, None, None, False) == ("k2", [])
    got = _chunk_rounds(box, cfg, 1, 32_768, 65_536,
                        photon._light_row(box, 0, 65_536))
    want = _chunk_rounds(box, cfg, 1, 32_768, 65_536, None)
    s = want[0].stored
    floor = int((want[0].pos[s, 1] < -3.99).sum())
    colours = torch.unique(want[0].col[s], dim=0).shape[0]
    print(f"\n{len(got[1])} rounds, live {got[1][:4]}...; {int(s.sum())} "
          f"stored, {floor} on the glossy floor, {colours} colours")
    _rounds_match(*got, *want[:2])
    assert floor > int(s.sum()) // 4 and colours >= 16


def test_photon_round_route(dev, scene):
    """``trace_photons`` takes the round kernel on the eligible box (one
    launch a round, no K2 launch of its own), and the staged round with a
    gradient, with another uniform source and on a scene with an analytic
    sphere; the two routes store the same slots."""
    from torch.profiler import ProfilerActivity, profile

    from gi_raytracer_tpu_torch import telemetry
    from gi_raytracer_tpu_torch.render import photon

    cfg = RenderConfig(photons=2_048, ray_chunk=1_024, seed=7)

    def rounds(fn):
        telemetry.reset()
        _cuda.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]):
            out = fn()
        torch.cuda.synchronize()
        got = [sp.attrs["route"] for sp in telemetry.records()
               if sp.name == "photons.round"]
        telemetry.reset()
        return out, set(got), dict(_cuda.launches)

    fast, r, launches = rounds(lambda: trace_photons(scene, cfg))
    assert r == {"k2"} and launches.get("intersect", 0) == 0
    assert launches["photon_round"] > 0

    class Replay(photon.ThreefryUniform):
        pass

    assert routes.photon_round(scene, cfg, None, Replay(cfg.seed, dev),
                               False) == (
        "staged", ["emission uniforms from Replay, not ThreefryUniform"])
    staged, r, launches = rounds(lambda: trace_photons(
        scene, cfg, uniform=Replay(cfg.seed, dev)))
    assert r == {"staged"} and launches.get("photon_round", 0) == 0
    assert torch.equal(fast.stored, staged.stored)
    _, r, _ = rounds(lambda: trace_photons(scene, cfg, differentiable=True))
    assert r == {"staged"}
    b = SceneBuilder()
    white = b.add_texture_const((0.9, 0.9, 0.9))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    v, n, uv = meshgen.sphere_mesh((0.0, -2.0, 0.0), 1.0, 1)
    b.add_triangles(v, n, uv, mat_id=b.add_material(white, black, 1.0, 1.0))
    b.add_sphere((0.0, 0.0, 0.0), 0.5,
                 b.add_material(white, black, 0.0, 0.0, 1.5))
    b.add_light((0.0, 3.0, 0.0), (8.0, 8.0, 8.0), 0.3)
    sph = b.build(device=dev)
    _, r, _ = rounds(lambda: trace_photons(sph, cfg))
    assert r == {"staged"}


# ---- the wave-inputs kernel (csrc/wave_inputs.cu) --------------------------

def _bits(t):
    return t.contiguous().view(torch.int32)


def _wave_inputs_equal(r, wave, pos=None):
    """One kernel launch of ``r.wave_inputs`` against its plain version:
    (ro, rd, sx_all, sy_all) bit for bit, shapes and dtypes alike."""
    before = _cuda.launches["wave_inputs"]
    got = r.wave_inputs(wave, pos)
    assert _cuda.launches["wave_inputs"] == before + 1
    want = r.wave_inputs_plain(r.halton_index(wave, pos))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        assert torch.equal(_bits(g), _bits(w))
    return got


@pytest.mark.parametrize("size, depth, wave", [(512, 8, 0), (512, 8, 7),
                                               (256, 3, 0)])
def test_wave_inputs_kernel_matches_plain(dev, scene, size, depth, wave):
    """The render cells' waves (512x512 at depth 8, waves 0 and 7; 256x256
    at depth 3): every Halton dim and the primary rays bit-equal to
    ``HaltonSampler.sample`` and ``primary_rays``."""
    r = Renderer(scene, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT),
                 RenderConfig(min_samples=8, max_samples=8, max_depth=depth),
                 size, size)
    assert r.frame_routes().inputs == "kernel"
    assert r._index_bits == (22 if size == 512 else 21)
    ro, rd, sx, sy = _wave_inputs_equal(r, wave)
    assert sx.shape == (depth, size * size) and rd.shape == (size * size, 3)


def test_wave_inputs_kernel_on_a_block_wave(dev, scene):
    """A block wave over drawn 16x16 blocks of the adaptive 8-32 spp frame
    (24 index bits): the kernel's lanes are ``pos``'s, as the plain
    version's."""
    r = Renderer(scene, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT),
                 RenderConfig(min_samples=8, max_samples=32, max_depth=8),
                 512, 512)
    assert r.block_adaptive and r._index_bits == 24
    g = torch.Generator(device=dev).manual_seed(3)
    blocks = torch.sort(torch.randperm(1024, generator=g, device=dev)[:417])[0]
    pos = (blocks[:, None] * 256 + torch.arange(256, device=dev)).reshape(-1)
    _wave_inputs_equal(r, 19, pos)
    ro, rd, sx, sy = r.wave_inputs(19)
    got = r.wave_inputs(19, pos)
    assert torch.equal(got[1], rd[pos]) and torch.equal(got[2], sx[:, pos])


@pytest.mark.parametrize("scramble", ["faure", "random"])
def test_wave_inputs_kernel_past_2_32(dev, scene, scramble):
    """Waves whose indices wrap past 2**32 (wave 11,507 of a 512x512 frame
    wraps its lanes with offsets past 2,560; wave 40,000 every lane), under
    Faure and shuffled digit permutations (whose zero digits' tail is not
    0), at depth 16, the last of the arithmetic range."""
    from gi_raytracer_tpu_torch.sampling.halton import HaltonSampler

    r = Renderer(scene, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT),
                 RenderConfig(max_depth=16), 512, 512)
    r.sampler = HaltonSampler(scramble, seed=11)
    assert r.frame_routes().inputs == "kernel"
    assert 11_507 * r.enum.increment + 2_560 == 2 ** 32
    for wave in (11_507, 40_000):
        _wave_inputs_equal(r, wave)


def test_wave_inputs_kernel_once_a_wave(dev, scene):
    """A render launches the kernel once a wave, every wave's set-up span
    names the kernel route, and the frame takes the camera's four copies
    once; with a camera that carries a gradient under grad mode the set-up
    is the plain version's."""
    from torch.profiler import ProfilerActivity, profile

    from gi_raytracer_tpu_torch import telemetry

    cam = Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT)
    r = Renderer(scene, cam, RenderConfig(min_samples=3, max_samples=3,
                                          max_depth=3), 64, 64)
    telemetry.reset()
    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]):
        r.render()
    torch.cuda.synchronize()
    recs = telemetry.records()
    telemetry.reset()
    assert _cuda.launches["wave_inputs"] == 3
    assert [sp.attrs.get("route") for sp in recs
            if sp.name == "wave.inputs"] == ["kernel"] * 3
    sites = [sp.attrs["site"] for sp in recs if sp.name == "sync"]
    assert sum(s.startswith("camera.") for s in sites) == 4
    r.camera = Camera(pos=torch.tensor(CAMERA_POS, device=dev,
                                       requires_grad=True),
                      look_at=CAMERA_LOOK_AT)
    assert routes.wave_inputs(r.cfg, r.device, r.sampler, r.camera) == (
        "torch",
        ["the camera carries a gradient: autograd must see the operations"])
    n = _cuda.launches["wave_inputs"]
    ro, rd, _, _ = r.wave_inputs(0)
    assert _cuda.launches["wave_inputs"] == n and rd.requires_grad


# ---- the full band's wave as one CUDA graph (Renderer.replay_wave) ---------

def _terrain_renderer(dev, size=64, **cfg):
    """A 28,322-triangle terrain (past K2's rows: K4) at 2 spp, depth 3."""
    ter = terrain_scene(SceneBuilder, 120).build(device=dev)
    assert routes.trace(ter)[0] == "k4"
    return Renderer(ter, Camera(pos=(0.0, 18.0, -30.0),
                                look_at=(0.0, 0.0, 0.0)),
                    RenderConfig(**dict(dict(
                        adaptive=False, min_samples=2, max_samples=2,
                        max_depth=3, seed=5), **cfg)),
                    size, size)


def _replay_equals_eager(r, wave):
    """``r.replay_wave`` on wave ``wave``'s inputs against the eager staged
    ``radiance_wave`` on the same lanes: radiance bit for bit, both
    counters equal.  Returns the radiance."""
    N = r.band_height * r.width
    ro, rd, sx, sy = r.wave_inputs(wave)
    lane = (wave * N + torch.arange(N, device=r.device)) & 0xFFFFFFFF
    got, (gc, gs) = r.replay_wave(ro, rd, sx, sy, lane)
    want, (wc, ws) = radiance_wave(r.scene, r.cfg, ro, rd, sx, sy, 0,
                                   r.photon_map, lane_base=wave * N,
                                   prim_rows=r.prim_rows())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), wave
    assert int(gc) == int(wc) > 0 and int(gs) == int(ws) > 0, wave
    return got


def test_wave_graph_replay_matches_eager_on_k4(dev):
    """The terrain's full band: the first wave runs eagerly and captures
    the graph, the next two replay it with other lane ids; each equals the
    eager wave on its lanes, and the two replays differ (the graph holds
    no result)."""
    r = _terrain_renderer(dev)
    _replay_equals_eager(r, 0)
    g = r._graph
    assert g is not None
    a = _replay_equals_eager(r, 1)
    b = _replay_equals_eager(r, 2)
    assert r._graph is g and not torch.equal(a, b)


def test_wave_graph_replay_matches_eager_on_the_analytic_box(dev):
    """The analytic box (spheres, a cone, an image texture): the analytic
    passes inside the graph, two replays.  With a photon map the frame
    refuses the graph (K3's work is counted in Python), and its frames
    run eagerly."""
    box = cornell_box(SceneBuilder, meshgen, False,
                      analytic=True).build(device=dev)
    cfg = RenderConfig(adaptive=False, min_samples=3, max_samples=3,
                       max_depth=4, knn_k=32, photons=65_536,
                       ray_chunk=65_536, seed=7)
    cam = Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT)
    r = Renderer(box, cam, cfg, 64, 64)
    f = r.frame_routes()
    assert (f.wave, f.graph) == ("staged", "replay")
    _replay_equals_eager(r, 0)
    g = r._graph
    _replay_equals_eager(r, 1)
    _replay_equals_eager(r, 2)
    assert r._graph is g
    batch = trace_photons(box, cfg)
    pm = build_photon_map(batch, box.world_min.cpu().numpy(),
                          box.world_max.cpu().numpy())
    rm = Renderer(box, cam, cfg, 64, 64, photon_map=pm)
    f = rm.frame_routes()
    assert (f.wave, f.graph) == ("staged", "eager")
    rm.render()
    assert rm._graph is None


def test_wave_graph_frames_equal_eager_frames(dev, monkeypatch):
    """Frames of replayed waves equal the frames of the same renderer's
    eager waves bit for bit, under an ambient light (every miss lane reads
    the ambient tensor the graph was captured with, long after the frame
    that made it ended), frame after frame."""
    amb = (0.25, 0.5, 0.125)
    r = _terrain_renderer(dev, ambient=amb)
    frames = [r.render() for _ in range(3)]
    assert r._graph is not None
    torch.cuda.empty_cache()
    frames.append(r.render())
    monkeypatch.setattr(routes, "wave_graph",
                        lambda *a, **k: ("eager", ["off for the test"]))
    want = _terrain_renderer(dev, ambient=amb).render()
    for got in frames:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_wave_graph_follows_an_in_place_scene_update(dev):
    """After an in-place update of the scene's vertices the next wave runs
    eagerly on the rebuilt tables and captures anew, and the replay after
    it equals the eager wave of the updated scene."""
    r = _terrain_renderer(dev)
    _replay_equals_eager(r, 0)
    _replay_equals_eager(r, 1)
    g = r._graph
    with torch.no_grad():
        r.scene.tris.v0[:, 1] += 0.25
    _replay_equals_eager(r, 1)
    assert r._graph is not g and r._graph is not None
    _replay_equals_eager(r, 0)


def test_wave_graph_frame_spans_and_syncs(dev):
    """A frame's staged waves under a profiler: every full-band wave
    replays (``wave.trace``'s ``graph``), a block wave of fewer lanes runs
    eagerly, the frame's syncs are its camera's and its ``frame.active``
    reads (the ambient tensor is the renderer's, made by the first
    frame), and the replays' kernels are in the device trace one by
    one."""
    from torch.profiler import ProfilerActivity, profile

    from gi_raytracer_tpu_torch import telemetry
    r = _terrain_renderer(dev)
    r.render()                  # the first wave captures the graph
    torch.cuda.synchronize(dev)
    telemetry.reset()
    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r.render()
        torch.cuda.synchronize(dev)
        r.block_wave(5, torch.arange(3, device=dev) * 2)
        torch.cuda.synchronize(dev)
    recs = telemetry.records()
    telemetry.reset()
    assert [(sp.attrs["route"], sp.attrs["graph"]) for sp in recs
            if sp.name == "wave.trace"] == [("staged", "replay")] * 2 + [
        ("staged", "eager")]
    frame_id = next(sp.id for sp in recs if sp.name == "frame")
    sites = sorted(sp.attrs["site"] for sp in recs
                   if sp.name == "sync" and sp.root == frame_id)
    assert sites == sorted(["camera.pos", "camera.look_at", "camera.up",
                            "camera.diag", "frame.active",
                            "frame.active"]), sites
    walks = [n for n, _, _ in _device_events(prof) if "gi_walk_kernel" in n]
    # each wave: a closest hit and a shadow ray a bounce, on K4
    assert _cuda.launches["stream"] == 3 * 2 * 3
    assert len(walks) == _cuda.launches["stream"], len(walks)
