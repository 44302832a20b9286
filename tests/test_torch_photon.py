"""Port parity of the photon subsystem against the JAX package:
(a) the kNN estimate's plain version (the CPU side of the K3 kernel)
against ``photon.sample_photons`` on the maps of tests/test_photon_knn.py
(rtol 2e-4, atol 1e-6); (b) ``build_photon_map`` (equal dims, cell_start,
order, window_cap); (c) photon emission with JAX's uniforms replayed into
the port (equal stored mask; dir and col within 1e-5 on >= 99.9% of
slots, positions within 3e-4, see the test)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.render import photon as jph
from gi_raytracer_tpu_torch import convert
from gi_raytracer_tpu_torch.render import photon as tph

from _torch_parity import jax_cornell, jax_uniform, port_scene, port_map


def _clustered(rng, P, spread):
    pos = rng.normal(0, spread, (P, 3))
    d = rng.normal(size=(P, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (P, 3))
    return [a.astype(np.float32) for a in (pos, d, col)]


def _queries(rng, R, spread=0.12):
    q = rng.normal(0, spread, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return q, d


def _case(name):
    """test_photon_knn.py's maps and query mixes: (photons, build kwargs,
    queries, directions)."""
    if name == "clustered":
        rng = np.random.default_rng(0)
        ph = _clustered(rng, 2000, 0.15)
        q, d = _queries(rng, 1024)
        return ph, {}, q, d
    if name == "mixed_occupancy":
        rng = np.random.default_rng(1)
        ph = _clustered(rng, 3000, 0.15)
        q_in, d_in = _queries(rng, 500)
        q_out = rng.uniform(1.0, 1.4, (500, 3)).astype(np.float32)
        return ph, {"window_cap": 1024}, np.concatenate([q_in, q_out]), \
            np.concatenate([d_in, d_in])
    if name == "uniform":
        rng = np.random.default_rng(2)
        ph = _clustered(rng, 5000, 0.6)
        q = rng.uniform(-1.4, 1.4, (2048, 3)).astype(np.float32)
        d = rng.normal(size=(2048, 3)).astype(np.float32)
        return ph, {}, q, d / np.linalg.norm(d, axis=1, keepdims=True)
    # dense focal cells: coincident photons force refinement and truncation
    rng = np.random.default_rng(3)
    pos = np.zeros((4000, 3), np.float32)
    pos[3000:] = rng.normal(0, 1e-3, (1000, 3))
    d = rng.normal(size=(4000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ph = [pos, d.astype(np.float32),
          rng.uniform(0, 1, (4000, 3)).astype(np.float32)]
    q, qd = _queries(rng, 256, spread=2e-4)
    return ph, {}, q, qd


CASES = ["clustered", "mixed_occupancy", "uniform", "dense_focal"]


def _maps(name):
    (pos, d, col), kw, q, qd = _case(name)
    P = pos.shape[0]
    jb = jph.PhotonBatch(jnp.asarray(pos), jnp.asarray(d), jnp.asarray(col),
                         jnp.ones(P, bool))
    tb = convert.photon_batch_from_arrays(pos, d, col, np.ones(P, bool),
                                          device="cpu")
    lo, hi = (-1.5,) * 3, (1.5,) * 3
    return (jph.build_photon_map(jb, lo, hi, **kw),
            tph.build_photon_map(tb, lo, hi, **kw), q, qd)


@pytest.mark.parametrize("name", CASES)
def test_knn_plain_matches_jax(name):
    jpm, _, q, qd = _maps(name)
    want = np.asarray(jph.sample_photons(jpm, jnp.asarray(q),
                                         jnp.asarray(qd), 32))
    got = tph.sample_photons(port_map(jpm), torch.from_numpy(q),
                             torch.from_numpy(qd), 32).numpy()
    assert (np.abs(want).sum(1) > 0).any()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_build_photon_map_matches_jax(name):
    jpm, tpm, _, _ = _maps(name)
    assert tpm.dims == jpm.dims
    assert tpm.window_cap == jpm.window_cap
    assert np.array_equal(tpm.cell_start.numpy(), np.asarray(jpm.cell_start))
    assert np.array_equal(tpm.order.numpy(), np.asarray(jpm.order))
    np.testing.assert_allclose(tpm.grid_min.numpy(), np.asarray(jpm.grid_min),
                               rtol=1e-7)
    np.testing.assert_allclose(tpm.inv_cell.numpy(), np.asarray(jpm.inv_cell),
                               rtol=1e-7)
    assert np.array_equal(tpm.pos.numpy(), np.asarray(jpm.pos))


def test_emission_matches_jax_with_replayed_uniforms():
    """2,048 slots, photon depth 5, on the Pallas route the port follows
    (the homogeneous accept test).  A stored position ends a chain of up to
    five specular bounces in float32; XLA's fused CPU code and torch's
    op-by-op kernels round some intermediates differently, and the
    refraction chain amplifies those last-bit differences: on this scene 91%
    of positions agree to 1e-5 and 99.95% to 3e-4 (scene units; the box is
    8 wide), so positions are held to 3e-4 and directions and colours to
    1e-5."""
    js = jax_cornell(False)
    ts = port_scene(js)
    jcfg = JaxConfig(photons=2048, photon_depth=5, photon_retries=64,
                     intersect_backend="pallas")
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    want = jph.trace_photons(js, jcfg)
    got = tph.trace_photons(ts, cfg, uniform=jax_uniform(jcfg.seed))
    ws = np.asarray(want.stored)
    assert ws.mean() > 0.98
    assert np.array_equal(got.stored.numpy(), ws)
    for f, tol in (("pos", 3e-4), ("dir", 1e-5), ("col", 1e-5)):
        g = getattr(got, f).numpy()[ws]
        w = np.asarray(getattr(want, f))[ws]
        ok = np.abs(g - w).max(1) <= tol
        assert ok.mean() >= 0.999, (f, ok.mean())
