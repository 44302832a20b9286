"""Port parity: the port's SceneBuilder against the JAX one, array by
array, on both Cornell sizes (both at their default SAH BVH) and on the
numpy median split (``use_native=False`` on both sides)."""

import numpy as np
import pytest
import torch

from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.ops.pallas_megakernel import mega_why_not as jax_why_not
from gi_raytracer_tpu_torch import convert
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
from gi_raytracer_tpu_torch.scene.cornell import (cornell_box, FULL_TRIS,
                                                  SMALL_TRIS)

from _torch_parity import (assert_scene_arrays_equal, jax_build,
                           jax_cornell, port_scene, to_numpy)


@pytest.fixture(scope="module", params=[False, True], ids=["small", "full"])
def scenes(request):
    full = request.param
    return (full, jax_cornell(full),
            cornell_box(SceneBuilder, meshgen, full).build(device="cpu"))


def test_builder_arrays_match(scenes):
    full, js, ts = scenes
    want = convert.scene_to_arrays(to_numpy(js))
    got = convert.scene_to_arrays(ts)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == np.float32, k
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        else:
            assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), k


def test_builder_arrays_match_median_split():
    """``use_native=False`` on both sides: the numpy median split, the
    same arrays, and another triangle order than the SAH build."""
    def pop(builder, mg):
        return cornell_box(builder, mg, True)

    js = jax_build(pop, use_native=False)
    ts = pop(SceneBuilder, meshgen).build(device="cpu", use_native=False)
    assert_scene_arrays_equal(ts, js)
    sah = pop(SceneBuilder, meshgen).build(device="cpu")
    assert not torch.equal(sah.tris.v0, ts.tris.v0)
    assert sah.bvh.n_nodes != ts.bvh.n_nodes or not torch.equal(
        sah.bvh.skip, ts.bvh.skip)


def test_builder_flags_and_counts(scenes):
    full, js, ts = scenes
    assert ts.n_tris == js.n_tris == (FULL_TRIS if full else SMALL_TRIS)
    assert ts.all_opaque == js.all_opaque is True
    assert ts.has_image_tex == js.has_image_tex is False
    assert ts.has_fog == js.has_fog is False
    assert ts.n_spheres == js.n_spheres == 0
    # the photon cone aims at the specular spheres
    np.testing.assert_allclose(ts.lights.dir.numpy(),
                               np.asarray(js.lights.dir), atol=1e-6)
    np.testing.assert_allclose(ts.lights.angle.numpy(),
                               np.asarray(js.lights.angle), atol=1e-6)
    assert 0.0 < float(ts.lights.angle[0]) < 1.0


def test_carried_scene_equals_built_scene(scenes):
    """convert.scene_from_arrays of the JAX scene == the port's own build."""
    _, js, ts = scenes
    carried = convert.scene_to_arrays(port_scene(js))
    built = convert.scene_to_arrays(ts)
    for k in built:
        assert np.array_equal(carried[k].astype(np.float64),
                              built[k].astype(np.float64)), k


def test_full_box_is_megakernel_eligible():
    ts = cornell_box(SceneBuilder, meshgen, True).build(device="cpu")
    # the port's side is tests/test_torch_routes.py's "cornell_full" case
    cfg = JaxConfig(max_depth=8, adaptive=False)
    assert jax_why_not(jax_cornell(True), cfg) == []
    # 2,198 triangles fill 18 chunks of 128
    assert -(-ts.n_tris // 128) == 18


def test_scene_moves_between_devices():
    ts = cornell_box(SceneBuilder, meshgen, False).build(device="cpu")
    moved = ts.to("cpu")
    assert moved is not ts and moved.all_opaque == ts.all_opaque
    assert torch.equal(moved.tris.v0, ts.tris.v0)


def test_derived_keys_tensors_by_version_and_objects_by_identity():
    """``types.derived`` builds again after a tensor source is replaced or
    updated in place, or an object source (no version) is another object,
    and keeps its value otherwise."""
    from types import SimpleNamespace

    from gi_raytracer_tpu_torch.scene.types import derived
    owner, t, cfg = SimpleNamespace(), torch.zeros(3), object()
    builds = []

    def get(*sources):
        return derived(owner, "_kept", sources,
                       lambda: builds.append(1) or len(builds))

    assert get(t, cfg) == get(t, cfg) == 1
    t += 1
    assert get(t, cfg) == 2
    assert get(t, object()) == 3
    assert get(t.clone(), cfg) == 4
