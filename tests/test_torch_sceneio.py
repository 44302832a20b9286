"""Port parity of the scene front end: the native SAH BVH builder and OBJ
parser, ``load_obj`` and ``load_scene`` against the JAX package's (both at
their default, native SAH builds); the bulk ``add_triangles``; the
terrain; and the entry points' default device (the card, raising without
one)."""

import inspect
import shutil

import numpy as np
import pytest
import torch

from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.native import build_bvh_native as jax_build_bvh_native
from gi_raytracer_tpu.scene.objio import load_obj as jax_load_obj
from gi_raytracer_tpu.scene.scn import load_scene as jax_load_scene
from gi_raytracer_tpu_torch import convert
from gi_raytracer_tpu_torch import native
from gi_raytracer_tpu_torch.config import RenderConfig
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
from gi_raytracer_tpu_torch.scene.bvh import build_bvh
from gi_raytracer_tpu_torch.scene.cornell import cornell_box
from gi_raytracer_tpu_torch.scene.objio import load_obj
from gi_raytracer_tpu_torch.scene.scn import load_scene
from gi_raytracer_tpu_torch.scene.terrain import terrain_scene, terrain_tris

from _torch_parity import assert_scene_arrays_equal, jax_build


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the native builders")


def _check_bvh_invariants(b, pmin, pmax):
    """tests/test_native.py's invariants of a flat skip-link BVH."""
    n = len(b.skip)
    P = len(pmin)
    assert sorted(b.prim_idx.tolist()) == list(range(P))
    assert (b.skip > np.arange(n)).all()
    assert (b.skip <= n).all()
    leaves = b.count > 0
    covered = np.zeros(P, bool)
    for f, c in zip(b.first[leaves], b.count[leaves]):
        assert not covered[f:f + c].any()
        covered[f:f + c] = True
    assert covered.all()
    for i in np.where(leaves)[0]:
        ids = b.prim_idx[b.first[i]:b.first[i] + b.count[i]]
        assert (pmin[ids] >= b.node_min[i] - 1e-4).all()
        assert (pmax[ids] <= b.node_max[i] + 1e-4).all()


@pytest.mark.parametrize("leaf_size", [1, 4, 7])
def test_native_bvh_invariants_and_jax_equality(gxx, leaf_size):
    rng = np.random.default_rng(leaf_size)
    c = rng.uniform(-5, 5, (500, 3))
    pmin = c - rng.uniform(0.05, 0.5, (500, 3))
    pmax = c + rng.uniform(0.05, 0.5, (500, 3))
    got = build_bvh(pmin, pmax, leaf_size)
    _check_bvh_invariants(got, pmin, pmax)
    want = jax_build_bvh_native(pmin, pmax, leaf_size)
    for name in ("node_min", "node_max", "skip", "first", "count",
                 "prim_idx"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    _check_bvh_invariants(build_bvh(pmin, pmax, leaf_size, use_native=False),
                          pmin, pmax)


def test_native_bvh_failure_raises(monkeypatch):
    """No quiet fallback to the median split (another triangle order)."""
    def broken():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(native, "lib", broken)
    with pytest.raises(RuntimeError, match="use_native=False"):
        build_bvh(np.zeros((3, 3)), np.ones((3, 3)))
    assert len(build_bvh(np.zeros((3, 3)), np.ones((3, 3)),
                         use_native=False).prim_idx) == 3


def _write_obj(path):
    """A subdivided sphere with v/vt/vn corners, a quad (fan-split) and a
    face written with negative indices."""
    v, n, uv = meshgen.sphere_mesh((0.0, 0.0, 0.0), 1.0, 2)
    lines = []
    for t in range(v.shape[0]):
        for k in range(3):
            lines.append("v %.7f %.7f %.7f" % tuple(v[t, k]))
            lines.append("vt %.7f %.7f" % tuple(uv[t, k]))
            lines.append("vn %.7f %.7f %.7f" % tuple(n[t, k]))
        b = 3 * t + 1
        lines.append(f"f {b}/{b}/{b} {b + 1}/{b + 1}/{b + 1} "
                     f"{b + 2}/{b + 2}/{b + 2}")
    for p in ((2, -1, 2), (3, -1, 2), (3, -1, 3), (2, -1, 3)):
        lines.append("v %g %g %g" % p)
    lines.append("f -4 -3 -2 -1")                       # quad, relative
    lines.append("f -4//1 -2//2 -1//3")
    path.write_text("# test mesh\n" + "\n".join(lines) + "\n")
    return v.shape[0] + 3


def test_load_obj_matches_jax(tmp_path):
    p = tmp_path / "mesh.obj"
    n_tris = _write_obj(p)
    for pos, rot in (((0, 0, 0), (0, 0, 0)), ((1.0, -2.0, 0.5),
                                               (0.3, -0.2, 1.1))):
        got = load_obj(str(p), pos, rot)
        want = jax_load_obj(str(p), pos, rot)
        assert got[0].shape == (n_tris, 3, 3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_native_obj_matches_python(gxx, tmp_path):
    p = tmp_path / "mesh.obj"
    n_tris = _write_obj(p)
    tv, tn, tuv = load_obj(str(p))
    v, vt, vn, fv, ft, fn = native.load_obj_native(str(p))
    assert fv.shape == (3 * n_tris,)

    def fix(idx, count):
        return np.where(idx > 0, idx - 1, np.where(idx < 0, count + idx, -1))

    fv = fix(fv.reshape(-1, 3).astype(np.int64), len(v))
    ft = fix(ft.reshape(-1, 3).astype(np.int64), len(vt))
    fn = fix(fn.reshape(-1, 3).astype(np.int64), len(vn))
    np.testing.assert_allclose(v[fv], tv, atol=1e-6)
    np.testing.assert_allclose(
        np.where((ft >= 0)[..., None], vt[np.maximum(ft, 0)], 0.0), tuv,
        atol=1e-6)
    np.testing.assert_allclose(
        np.where((fn >= 0)[..., None], vn[np.maximum(fn, 0)], 0.0), tn,
        atol=1e-6)
    with pytest.raises(OSError):
        native.load_obj_native(str(tmp_path / "missing.obj"))


_SCN = """# a mesh, a box, a light, a camera and the config directives
colorTex 0.9 0.9 0.9
colorTex 0.8 0.2 0.2
checkerboardTex 0.1 0.1 0.1 0.9 0.9 0.9 8
colorTex 0 0 0
mat 0 3 1.0 1.0
mat 1 3 0.0 0.0 1.5
mat 2 3 1.0 1.0 1.0
multiMat 0 1 2
mesh mesh.obj 0.5 -1 0.25 0.1 0.7 -0.3 1
box 0 -3 0 8 0.5 8 0 0.2 0 2
box -2 0 1 1 2 1 0.3 0 0 0
light 0 4 0 8 8 8 0.3
photons 20000 4
samples 2 6 0.01
ambient 0.01 0.02 0.03
camera 1 2 -9 0 0 0
"""


def test_load_scene_matches_jax(gxx, tmp_path):
    _write_obj(tmp_path / "mesh.obj")
    (tmp_path / "s.scn").write_text(_SCN)
    path = str(tmp_path / "s.scn")
    want = jax_load_scene(path, JaxConfig(seed=3), dtype=np.float32)
    got = load_scene(path, RenderConfig(seed=3), device="cpu")
    assert got.scene.n_tris == want.scene.n_tris > 16
    assert got.scene.device == torch.device("cpu")
    assert_scene_arrays_equal(got.scene, want.scene)
    assert got.scene.all_opaque == want.scene.all_opaque
    assert got.camera_pos == want.camera_pos == (1.0, 2.0, -9.0)
    assert got.camera_look_at == want.camera_look_at
    for k in ("photons", "photon_depth", "min_samples", "max_samples",
              "noise_thresh", "ambient", "seed"):
        assert getattr(got.config, k) == getattr(want.config, k), k


@pytest.mark.parametrize("line", ["sphere 0 0 0 1 0",
                                  "cone 0 0 0 0 0 0 1 2 0",
                                  "heightFog 0 0 0 1 1 1 1 1 1 0.1 0.5 4",
                                  "imTex tex.png 1 1"])
def test_load_scene_refuses_unported_directives(tmp_path, line):
    """These directives were refused until the port carried them; each now
    loads to the JAX loader's arrays (the name is kept from then)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (6, 5, 4), dtype=np.uint8),
                    "RGBA").save(tmp_path / "tex.png")
    (tmp_path / "s.scn").write_text("colorTex 1 1 1\nmat 0 0 1 1\n"
                                    "box 0 0 0 1 1 1 0 0 0 0\n"
                                    + line + "\n")
    path = str(tmp_path / "s.scn")
    want = jax_load_scene(path, JaxConfig(seed=2), dtype=np.float32)
    got = load_scene(path, RenderConfig(seed=2), device="cpu")
    assert_scene_arrays_equal(got.scene, want.scene, atol=0)
    assert got.scene.has_image_tex == want.scene.has_image_tex
    assert (got.scene.n_spheres + got.scene.n_cones + got.scene.has_fog
            + got.scene.has_image_tex) == 1


def test_bulk_add_triangles_matches_one_at_a_time():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(50, 3, 3))
    n = rng.normal(size=(50, 3, 3))
    n[::7] = 0.0                          # zero normals stay zero
    uv = rng.uniform(size=(50, 3, 2))
    bulk, single = SceneBuilder(), SceneBuilder()
    for b in (bulk, single):
        t = b.add_texture_const((1, 1, 1))
        b.add_material(t, t, 0.05, 1.0)       # specular: light cone too
        b.add_light((0, 5, 0), (1, 1, 1), 0.2)
    bulk.add_triangles(v, n, uv, 0)
    for i in range(50):
        single.add_triangle(v[i], n[i], uv[i], 0)
    got = bulk.build(device="cpu", dtype=torch.float64)
    want = single.build(device="cpu", dtype=torch.float64)
    assert_scene_arrays_equal(got, want, atol=0.0)


def test_terrain_matches_jax_builder():
    js = jax_build(lambda b, mg: terrain_scene(b, 40))
    ts = terrain_scene(SceneBuilder, 40).build(device="cpu")
    assert ts.n_tris == terrain_tris(40) == 39 * 39 * 2
    assert_scene_arrays_equal(ts, js)


def test_entry_points_default_to_the_card():
    for fn in (SceneBuilder.build, load_scene, convert.scene_from_arrays,
               convert.photon_batch_from_arrays,
               convert.photon_map_from_arrays):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cornell_box(SceneBuilder, meshgen, False).build()
    (tmp_path / "s.scn").write_text("colorTex 1 1 1\nmat 0 0 1 1\n"
                                    "box 0 0 0 1 1 1 0 0 0 0\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_scene(str(tmp_path / "s.scn"))
    z = np.zeros((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.photon_batch_from_arrays(z, z, z, np.ones(2, bool))
    assert convert.photon_batch_from_arrays(
        z, z, z, np.ones(2, bool), device="cpu").pos.device.type == "cpu"
