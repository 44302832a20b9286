"""Port parity of the gradient path (``gi_raytracer_tpu_torch.gradcheck``,
the kNN ``autograd.Function``, ``trace_photons(differentiable=True)`` and
``PhotonMap.rebind``, ``Renderer._wave``) against the JAX package on the
CPU, on the scenes of ``tests/test_gradients.py`` built by both packages
in float64.

The five fast families (light colour, texture colour, roughness, IOR,
vertices) hold the port's analytic gradient to JAX ``gradcheck``'s on the
same scene (rtol 1e-6, atol 1e-9: the same float64 estimator, summed in
another order; measured at most 2.2e-14 relative and 1.1e-17 absolute,
the largest relative one on IOR) and the port's own FD check
to the JAX test's tolerance (rel_err < 1e-2, IOR 5e-2).  The camera and
photon-path families run the port's FD check only (the JAX side of both
is a slow test)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu import gradcheck as jgc
from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.render import photon as jph
from gi_raytracer_tpu.scene import SceneBuilder as JaxBuilder
from gi_raytracer_tpu.scene import meshgen as jmeshgen
from gi_raytracer_tpu_torch import gradcheck as tgc
from gi_raytracer_tpu_torch.config import RenderConfig
from gi_raytracer_tpu_torch.render import Camera, Renderer
from gi_raytracer_tpu_torch.render.integrator import dispatch_wave
from gi_raytracer_tpu_torch.render import photon as tph
from gi_raytracer_tpu_torch.render.photon_knn import (FAR, _knn_tables,
                                                      sample_photons_plain,
                                                      sample_photons_tiled)
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen

from _torch_parity import (assert_scene_arrays_equal, jax_uniform, port_map,
                           random_photon_batch)

RTOL, ATOL = 1e-6, 1e-9        # port analytic against JAX analytic


class _LS:
    """The load_scene-like record the checkers take."""

    def __init__(self, scene, cfg, cam_pos, cam_look):
        self.scene = scene
        self.config = cfg
        self.camera_pos = cam_pos
        self.camera_look_at = cam_look


def _box(b, mg, with_glass=False, rough=1.0):
    """tests/test_gradients.py's closed diffuse box and area light."""
    white = b.add_texture_const((0.9, 0.9, 0.9))
    red = b.add_texture_const((0.8, 0.2, 0.2))
    blue = b.add_texture_const((0.2, 0.2, 0.8))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    m_white = b.add_material(white, black, rough, 1.0, 1.0)
    m_red = b.add_material(red, black, rough, 1.0, 1.0)
    m_blue = b.add_material(blue, black, rough, 1.0, 1.0)
    s = 4.0
    quad = mg.quad_mesh
    b.add_triangles(quad((-s, -s, -s), (s, -s, -s), (-s, -s, s), (s, -s, s)),
                    mat_id=m_white)
    b.add_triangles(quad((-s, s, -s), (s, s, -s), (-s, s, s), (s, s, s)),
                    mat_id=m_white)
    b.add_triangles(quad((-s, -s, s), (s, -s, s), (-s, s, s), (s, s, s)),
                    mat_id=m_white)
    b.add_triangles(quad((-s, -s, -s), (-s, -s, s), (-s, s, -s), (-s, s, s)),
                    mat_id=m_red)
    b.add_triangles(quad((s, -s, s), (s, -s, -s), (s, s, s), (s, s, -s)),
                    mat_id=m_blue)
    if with_glass:
        m_glass = b.add_material(white, black, 0.0, 0.0, 1.5)
        b.add_sphere((0.0, -2.0, 0.0), 1.2, m_glass)
    b.add_light((0.0, 3.0, 0.0), (8.0, 8.0, 8.0), 0.3)
    return (0.0, 0.0, -14.0), (0.0, 0.0, 0.0)


def _floor(b, mg):
    """tests/test_gradients.py's one huge diffuse floor quad."""
    white = b.add_texture_const((0.9, 0.9, 0.9))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    m = b.add_material(white, black, 1.0, 1.0, 1.0)
    b.add_triangles(mg.quad_mesh((-50, 0, -50), (50, 0, -50), (-50, 0, 50),
                                 (50, 0, 50)), mat_id=m)
    b.add_light((0.0, 8.0, 0.0), (20.0, 20.0, 20.0), 0.3)
    return (0.0, 5.0, -6.0), (0.0, 0.0, 0.0)


def _scenes(populate):
    """(JAX record, port record) of one scene built by both packages in
    float64, their arrays checked equal."""
    jb, tb = JaxBuilder(), SceneBuilder()
    cam = populate(jb, jmeshgen)
    populate(tb, meshgen)
    js = jb.build(dtype=np.float64)
    ts = tb.build(dtype=torch.float64, device="cpu")
    assert_scene_arrays_equal(ts, js, atol=0)
    return (_LS(js, JaxConfig(dtype="float64"), *cam),
            _LS(ts, RenderConfig(dtype="float64"), *cam))


@pytest.fixture(scope="module")
def box():
    return _scenes(_box)


@pytest.fixture(scope="module")
def box_glass():
    return _scenes(lambda b, mg: _box(b, mg, with_glass=True))


FAST = [("light_col", "box", 1e-2), ("texture_col", "box", 1e-2),
        ("roughness", "box", 1e-2), ("ior", "box_glass", 5e-2),
        ("vertices", "floor", 1e-2)]


@pytest.mark.parametrize("name,where,tol", FAST, ids=[f[0] for f in FAST])
def test_family_matches_jax_gradcheck(name, where, tol, request):
    """The port's analytic gradient equals JAX gradcheck's on the same
    float64 scene, and its FD check passes at the JAX test's tolerance."""
    jls, tls = (_scenes(_floor) if where == "floor"
                else request.getfixturevalue(where))
    want = jgc.ALL_CHECKS[name](jls)
    got = tgc.ALL_CHECKS[name](tls)
    assert got.name == want.name
    np.testing.assert_allclose(got.analytic, want.analytic, rtol=RTOL,
                               atol=ATOL)
    assert got.rel_err < tol, (got.rel_err, got.analytic, got.fd)
    assert (np.abs(got.analytic) > 0).any()


def test_camera_family_fd(box):
    rep = tgc.check_camera(box[1])
    assert rep.ok, (rep.rel_err, rep.analytic, rep.fd)
    assert (np.abs(rep.analytic) > 0).any()


def _glass_floor(b, mg):
    """tests/test_gradients.py's photon-path scene: a diffuse floor
    triangle under a glass sphere and a small light."""
    white = b.add_texture_const((1.0, 1.0, 1.0))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    diffuse = b.add_material(white, black, 1.0, 1.0, 1.0)
    glass = b.add_material(white, black, 0.0, 0.0, 1.5)
    b.add_triangle([(-20, 0, -20), (20, 0, -20), (0, 0, 30)], mat_id=diffuse)
    b.add_sphere((0, 2, 0), 0.7, glass)
    b.add_light((0, 6, 0), (10, 10, 10), 0.05)


def test_photon_path_family_fd():
    """Gradients survive trace_photons(differentiable) -> rebind -> the kNN
    estimate, on JAX's replayed emission draws."""
    b = SceneBuilder()
    _glass_floor(b, meshgen)
    scene = b.build(dtype=torch.float64, device="cpu")
    cfg = RenderConfig(photons=512, photon_depth=5, dtype="float64")
    rep = tgc.check_light_color_through_photons(scene, cfg,
                                                uniform=jax_uniform(cfg.seed))
    assert rep.ok, (rep.rel_err, rep.analytic, rep.fd)
    assert (np.abs(rep.analytic) > 0).any(), "photon-path gradient is zero"


# ---- the kNN autograd.Function --------------------------------------------

def _knn_case(rng, P=1600, R=96, dtype=np.float64):
    """A JAX map of the random photons of a box with no photon in the slab
    |x| < 0.8 (the last 40 unstored), its port copy and R queries: most in
    the box, 8 in the middle of the empty slab (empty windows), 8 far
    sentinels, and 8 in a corner whose window holds fewer than k
    photons."""
    pos, d, col = random_photon_batch(rng, P, -1.0, 1.0)
    keep = np.abs(pos[:, 0]) > 0.8
    pos, d, col = pos[keep], d[keep], col[keep]
    P = pos.shape[0]
    stored = np.ones(P, bool)
    stored[-40:] = False
    jpm = jph.build_photon_map(
        jph.PhotonBatch(jnp.asarray(pos, dtype), jnp.asarray(d, dtype),
                        jnp.asarray(col, dtype), jnp.asarray(stored)),
        -np.ones(3), np.ones(3))
    q = rng.uniform(-0.9, 0.9, (R, 3))
    q[:8, 0] = 0.0
    q[8:16, 0] = 2 * FAR
    q[16:24] = 0.999
    qd = rng.normal(size=(R, 3))
    qd /= np.linalg.norm(qd, axis=1, keepdims=True)
    return jpm, port_map(jpm), q.astype(dtype), qd.astype(dtype)


def _leaves(tpm, q, qd):
    pm = dataclasses.replace(
        tpm, pos=tpm.pos.double().requires_grad_(True),
        dir=tpm.dir.double().requires_grad_(True),
        col=tpm.col.double().requires_grad_(True))
    pt = torch.tensor(q, dtype=torch.float64, requires_grad=True)
    dr = torch.tensor(qd, dtype=torch.float64, requires_grad=True)
    return pm, pt, dr


def _grads(fn, pm, pt, dr, k, w):
    est = fn(pm, pt, dr, k)
    return est, torch.autograd.grad(torch.sum(w * est),
                                    (pt, dr, pm.pos, pm.dir, pm.col))


def test_knn_function_grads_equal_autograd_of_plain():
    """On the CPU the Function's forward is the plain version and its
    backward the plain estimator's VJP, chunk by chunk: both equal autograd
    through sample_photons_plain (1e-12), with 32-lane chunks."""
    jpm, tpm, q, qd = _knn_case(np.random.default_rng(11))
    pm, pt, dr = _leaves(tpm, q, qd)
    w = torch.from_numpy(np.random.default_rng(12).normal(size=(q.shape[0],
                                                                 3)))
    est_f, g_f = _grads(sample_photons_tiled, pm, pt, dr, 8, w)
    est_p, g_p = _grads(lambda *a: sample_photons_plain(*a, lane_chunk=32),
                        pm, pt, dr, 8, w)
    assert torch.equal(est_f, est_p)
    for a, b in zip(g_f, g_p):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)
    assert (g_f[4].abs() > 0).any() and (g_f[0].abs() > 0).any()


def test_knn_function_grads_match_jax_sample_photons():
    """Gradients with respect to the photon colours and the query points
    equal jax.grad of JAX's per-point sample_photons on the same map
    (float32; rtol 5e-3, atol 1e-5, as tests/test_photon_knn.py holds the
    JAX tiled VJP to it)."""
    jpm, tpm, q, qd = _knn_case(np.random.default_rng(4), dtype=np.float32)

    def jloss(col, qq):
        return jnp.sum(jph.sample_photons(jpm.replace(col=col), qq,
                                          jnp.asarray(qd), 8) ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(jpm.col, jnp.asarray(q))
    col = tpm.col.clone().requires_grad_(True)
    pt = torch.from_numpy(q).requires_grad_(True)
    est = sample_photons_tiled(dataclasses.replace(tpm, col=col), pt,
                               torch.from_numpy(qd), 8)
    got = torch.autograd.grad(torch.sum(est ** 2), (col, pt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3,
                                   atol=1e-5)
    assert (got[0].abs() > 0).any()


def test_knn_grads_finite_on_empty_far_and_sparse_windows():
    """Empty windows and far sentinels get exactly zero gradient, windows
    with fewer than k photons a finite one; nothing is NaN or inf."""
    jpm, tpm, q, qd = _knn_case(np.random.default_rng(5))
    pm, pt, dr = _leaves(tpm, q, qd)
    w = torch.ones((q.shape[0], 3), dtype=torch.float64)
    est, grads = _grads(sample_photons_tiled, pm, pt, dr, 32, w)
    for g in grads:
        assert torch.isfinite(g).all()
    assert (_window_counts(tpm, pt[:8]) == 0).all()
    assert torch.equal(est[:16], torch.zeros_like(est[:16]))
    assert torch.equal(grads[0][:16], torch.zeros_like(grads[0][:16]))
    assert (est[16:24].abs() > 0).any()            # the sparse corner
    n_sparse = [int(n) for n in _window_counts(tpm, pt[16:24])]
    assert min(n_sparse) < 32, n_sparse


def _window_counts(pm, pts):
    from gi_raytracer_tpu_torch.render.photon_knn import _cells, _window
    n = torch.zeros(pts.shape[0], dtype=torch.int64)
    for start, end, dup in _window(pm, _cells(pm, pts.detach())):
        n += torch.where(dup, 0, end - start)
    return n


# ---- stale tables after an in-place update --------------------------------

def test_in_place_vertex_update_then_second_gradient_is_fresh():
    """Move the floor's vertices in place (an optimizer step on a leaf),
    from out of the camera's view into it, and take a second gradient: the
    trace tables and chunk boxes kept on the scene are rebuilt (stale ones
    would select no hit), so the image and its gradient equal those of a
    scene built with the moved vertices."""
    b = SceneBuilder()
    cam_pos, cam_look = _floor(b, meshgen)
    scene = b.build(dtype=torch.float64, device="cpu")
    cfg = RenderConfig(dtype="float64", adaptive=False, min_samples=1,
                       max_samples=1, max_depth=2)
    r = Renderer(scene, Camera(pos=cam_pos, look_at=cam_look), cfg, 16, 16)
    idx = r.enum.index_image(0).reshape(-1)

    def loss_and_grad(s, leaf):
        loss = torch.mean(r._wave(s, None, idx, 0))
        return loss.detach(), torch.autograd.grad(loss, leaf)[0]

    leaf = scene.tris.v0.clone()
    leaf[:, 0] += 500.0                         # out of view
    leaf.requires_grad_(True)
    s = dataclasses.replace(scene, tris=dataclasses.replace(scene.tris,
                                                            v0=leaf))
    l0, _ = loss_and_grad(s, leaf)
    with torch.no_grad():
        leaf[:, 0] -= 500.0                     # back under the camera
    l1, g1 = loss_and_grad(s, leaf)
    moved = leaf.detach().clone().requires_grad_(True)
    fresh = dataclasses.replace(scene, tris=dataclasses.replace(scene.tris,
                                                                v0=moved))
    l2, g2 = loss_and_grad(fresh, moved)
    assert l0 == 0 and l1 > 0
    assert torch.equal(l1, l2)
    assert torch.equal(g1, g2)


def test_in_place_map_update_rebuilds_knn_tables():
    """K3's float32 copy of a float64 map follows an in-place update."""
    _, tpm, _, _ = _knn_case(np.random.default_rng(6))
    pm = dataclasses.replace(tpm, col=tpm.col.double())
    first = _knn_tables(pm)[2]
    assert torch.equal(first, pm.col.float())
    pm.col.mul_(2.0)
    assert torch.equal(_knn_tables(pm)[2], pm.col.float())
    assert _knn_tables(pm)[2] is _knn_tables(pm)[2]


# ---- the megakernel refuses gradients -------------------------------------

def test_megakernel_refuses_inputs_that_need_a_gradient():
    b = SceneBuilder()
    cam_pos, cam_look = _box(b, meshgen)
    scene = b.build(device="cpu")
    cfg = RenderConfig(adaptive=False, min_samples=1, max_samples=1,
                       max_depth=2, integrator="mega")
    r = Renderer(scene, Camera(pos=cam_pos, look_at=cam_look), cfg, 16, 16)
    ro, rd, sx, sy = r.wave_inputs(0)
    lane = torch.arange(ro.shape[0])
    dispatch_wave(scene, cfg, ro, rd, sx, sy, lane_ids=lane)  # no gradient
    col = scene.lights.col.clone().requires_grad_(True)
    lit = dataclasses.replace(scene, lights=dataclasses.replace(scene.lights,
                                                                col=col))
    with pytest.raises(ValueError, match="forward-only"):
        dispatch_wave(lit, cfg, ro, rd, sx, sy, lane_ids=lane)
    with pytest.raises(ValueError, match="forward-only"):
        dispatch_wave(scene, cfg, ro.clone().requires_grad_(True), rd, sx,
                      sy, lane_ids=lane)
    with torch.no_grad():
        dispatch_wave(lit, cfg, ro, rd, sx, sy, lane_ids=lane)


# ---- differentiable photon tracing ----------------------------------------

def test_differentiable_trace_equals_plain_trace_on_stored_slots():
    """trace_photons(differentiable=False) keeps no graph even when a leaf
    needs a gradient, and is the same batch as under no_grad; the
    differentiable batch stores the same slots with the same photons, and
    its colours carry the light's gradient."""
    b = SceneBuilder()
    _glass_floor(b, meshgen)
    scene = b.build(dtype=torch.float64, device="cpu")
    cfg = RenderConfig(photons=512, photon_depth=5, photon_retries=4,
                       dtype="float64")
    uni = jax_uniform(cfg.seed)
    col = scene.lights.col.clone().requires_grad_(True)
    lit = dataclasses.replace(scene, lights=dataclasses.replace(scene.lights,
                                                                col=col))
    plain = tph.trace_photons(lit, cfg, uniform=uni)
    with torch.no_grad():
        again = tph.trace_photons(lit, cfg, uniform=uni)
    diff = tph.trace_photons(lit, cfg, uniform=uni, differentiable=True)
    assert not any(t.requires_grad for t in plain)
    for a, b_ in zip(plain, again):
        assert torch.equal(a, b_)
    assert torch.equal(diff.stored, plain.stored)
    ok = plain.stored
    assert ok.float().mean() > 0.05
    for f in ("pos", "dir", "col"):
        assert torch.equal(getattr(diff, f).detach()[ok],
                           getattr(plain, f)[ok]), f
    assert diff.col.requires_grad
    g = torch.autograd.grad(diff.col.sum(), col)[0]
    assert (g.abs() > 0).all()


def test_rebind_keeps_structure_and_reorders_photons():
    rng = np.random.default_rng(7)
    pos, d, col = random_photon_batch(rng, 300, -1.0, 1.0)
    batch = tph.PhotonBatch(torch.from_numpy(pos), torch.from_numpy(d),
                            torch.from_numpy(col), torch.ones(300,
                                                              dtype=bool))
    pm = tph.build_photon_map(batch, -np.ones(3), np.ones(3))
    leaf = batch.col.clone().requires_grad_(True)
    re = pm.rebind(batch._replace(col=leaf))
    assert torch.equal(re.pos, pm.pos) and torch.equal(re.col, pm.col)
    assert re.cell_start is pm.cell_start and re.dims == pm.dims
    assert re.window_cap == pm.window_cap and re.order is pm.order
    assert re.col.requires_grad


# ---- cli grad-check --------------------------------------------------------

GRAD_SCENE = """colorTex 0.9 0.9 0.9
colorTex 0 0 0
colorTex 0.8 0.2 0.2
mat 0 1 1 1
mat 2 1 0.5 1
box 0 0 0 8 8 8 0 0 0 0
box 1 -3 1 1.5 2 1.5 0 0.4 0 1
light 0 3 0 4 4 4 0.3
camera 0 0 -3.5 0 0 0
"""


def test_cli_grad_check_prints_one_line_per_family(tmp_path, capsys,
                                                   monkeypatch):
    """One JSON line per family of ALL_CHECKS, as the JAX CLI prints them;
    on this float32 box the smooth families pass (the vertex and camera
    checks cross the inner box's edges, where FD is not exact); a family
    that raises prints an error line and the rest still run."""
    import json
    from gi_raytracer_tpu_torch import cli

    scn = tmp_path / "box.scn"
    scn.write_text(GRAD_SCENE)
    cli.main(["grad-check", str(scn), "-W", "16", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    got = {x["metric"]: x for x in lines}
    assert list(got) == [f"grad_rel_err_{n}" for n in tgc.ALL_CHECKS]
    for name in ("light_col", "texture_col", "roughness", "ior"):
        assert got[f"grad_rel_err_{name}"]["pass"], name
    for x in lines:
        assert np.isfinite(x["value"]) and np.isfinite(x["analytic"]).all()

    def broken(ls, size):
        raise RuntimeError("broken family")

    monkeypatch.setattr(tgc, "ALL_CHECKS", {"broken": broken,
                                            "ior": tgc.check_ior})
    cli.main(["grad-check", str(scn), "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[0] == {"metric": "grad_rel_err_broken",
                        "error": "broken family", "pass": False}
    assert lines[1]["metric"] == "grad_rel_err_ior" and lines[1]["pass"]
