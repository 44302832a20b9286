"""Shared helpers of the torch-port parity tests (tests/test_torch_*.py).

Both packages build the same Cornell box (``gi_raytracer_tpu_torch.scene.
cornell``); both take their default native binned-SAH BVH, so both sides
hold identical triangle order (``use_native=False`` pins the JAX builder to
its numpy median split, the port's ``build(use_native=False)``).  The JAX
scene is then carried into the port, on the CPU, through ``convert``.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from gi_raytracer_tpu_torch import convert
from gi_raytracer_tpu_torch.scene.cornell import cornell_box
from gi_raytracer_tpu_torch.scene.types import Scene as PortScene

# The suite runs in several worker processes at once (pytest-xdist); torch's
# default of one intra-op thread per core oversubscribes the machine, and
# these small-tensor tests ran 1.6x (the whole set) to 3x (the photon pass)
# slower with it.
torch.set_num_threads(1)

# A camera inside the box (the Cornell camera at z = -14 sits outside the
# scene's bounds, where the JAX megakernel's world-diagonal hit cap drops
# the far walls; the port does not cap).  On this camera's first waves the
# JAX megakernel and the JAX staged wave agree on every lane.
TEST_CAMERA_POS = (-0.4, 0.3, -3.8)
TEST_CAMERA_LOOK_AT = (0.0, 0.0, 0.0)


def jax_build(populate, use_native: bool = True):
    """``populate(SceneBuilder, meshgen)`` built by the JAX package
    (float32; its default SAH BVH, or the numpy median split)."""
    import gi_raytracer_tpu.scene.build as jb
    from gi_raytracer_tpu.scene import meshgen as jmeshgen

    if use_native:
        return populate(jb.SceneBuilder, jmeshgen).build(dtype=np.float32)
    orig = jb.build_bvh
    jb.build_bvh = functools.partial(orig, use_native=False)
    try:
        return populate(jb.SceneBuilder, jmeshgen).build(dtype=np.float32)
    finally:
        jb.build_bvh = orig


def jax_cornell(full: bool = False):
    """The JAX package's Cornell box (float32, SAH BVH)."""
    return jax_build(lambda builder, mg: cornell_box(builder, mg, full))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_scene(jax_scene):
    """The port's copy of a JAX scene (identical arrays)."""
    return convert.scene_from_arrays(
        convert.scene_to_arrays(to_numpy(jax_scene)),
        all_opaque=jax_scene.all_opaque,
        has_image_tex=jax_scene.has_image_tex, device="cpu")


def port_map(jax_map):
    """The port's copy of a JAX PhotonMap."""
    m = to_numpy(jax_map)
    return convert.photon_map_from_arrays(
        {k: getattr(m, k) for k in ("pos", "dir", "col", "valid",
                                     "cell_start", "grid_min", "inv_cell",
                                     "order")},
        dims=jax_map.dims, window_cap=jax_map.window_cap, device="cpu")


def assert_scene_arrays_equal(got_scene, want_scene, atol=1e-6):
    """Every array of two scenes (port or JAX, any field objects) equal:
    floats within ``atol``, integers exactly."""
    def arrays(scene):
        if not isinstance(scene, PortScene):
            scene = to_numpy(scene)
        return convert.scene_to_arrays(scene)

    want, got = arrays(want_scene), arrays(got_scene)
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)
        else:
            assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), k


def random_photon_batch(rng, P, lo, hi):
    """(pos, dir, col) float32 numpy arrays of P random photons in a box."""
    pos = rng.uniform(lo, hi, (P, 3)).astype(np.float32)
    d = rng.normal(size=(P, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    col = rng.uniform(0, 0.1, (P, 3)).astype(np.float32)
    return pos, d, col


def jax_uniform(seed):
    """Replays the draws of the JAX emission (photon.py:108-109,154-156,
    229,285) along the same key path: chunk, round, purpose, light
    (, depth)."""
    key = jax.random.PRNGKey(seed)

    def uniform(li, chunk, rnd, depth, shape, dtype=torch.float32):
        kr = jax.random.fold_in(jax.random.fold_in(key, chunk), rnd)
        if depth < 0:      # PHOTON_EMIT_X: the emission direction
            k = jax.random.fold_in(jax.random.fold_in(kr, 8), li)
        else:              # PHOTON_ALPHA: the chain's BSDF uniforms
            k = jax.random.fold_in(jax.random.fold_in(
                jax.random.fold_in(kr, 10), li), depth)
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        return torch.from_numpy(np.array(jax.random.uniform(k, shape, jdt)))

    return uniform
