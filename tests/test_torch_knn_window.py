"""The port's caustic estimate counts the whole 27-cell window, as the TPU
kNN kernels do (``render/photon_knn.py:71`` ``_knn_kernel``, ``:652,696``
``_tile_kernel_small/_large``), on maps where the per-cell window cap
binds: the map builder refines its grid until the densest cell fits
``window_cap_max`` (96) and clamps ``window_cap`` there, and a near-
coincident blob that no resolution splits leaves the densest cell past it,
as the caustic foci of every real map do.

(a) ``sample_photons_tiled`` (on the CPU its plain version, the function
K3 computes on the card) against JAX ``_fwd_perpoint`` in interpret mode
on the queries with at most 2,048 candidates, which every JAX accelerator
path computes exactly (past 2,048 the JAX router falls back to the capped
estimator; the port does not); (b) every query, larger windows included
(past 30,000 candidates at a near-point focus, the size K3's focal tier
stages), against a float64 brute-force oracle over the query's own
window; (c)
``knn_backend="jnp"`` against JAX ``photon.sample_photons``, the capped
estimator; (d) the whole-window estimator's gradients: gradcheck in
float64 under a binding cap, and jax.grad through JAX
``sample_photons_tiled`` (interpret) on a map whose windows fit 16 chunk
rows of 32 photons, where every JAX path is exact.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu.render import photon as jph
from gi_raytracer_tpu.render.photon_knn import (TIER_CAPS, _fwd_perpoint,
                                                _window_runs,
                                                sample_photons_tiled as
                                                jax_tiled)
from gi_raytracer_tpu_torch.render import photon as tph
from gi_raytracer_tpu_torch.render.photon_knn import (_cells, _window,
                                                      sample_photons_tiled)

from _torch_parity import port_map

K = 32
# blobs (centre, photons, sigma): near-coincident ones no grid of the
# test's cell budget splits, and a spread cluster
BLOBS = (((0.0, 0.0, 0.0), 3000, 1e-4), ((0.3, -0.2, 0.1), 300, 1e-4),
         ((0.0, 0.0, 0.0), 4000, 0.15))
BACKGROUND = 3000
MAX_CELLS = 262_144            # 64^3: keeps the CPU's cell arrays small


def _directions(rng, n):
    """Unit vectors about +z, as light arriving from above: the weights
    dot(dir, qdir) are mostly positive, so no channel of an estimate is a
    near-cancelling sum whose last bits depend on the order of the sum."""
    d = rng.normal(size=(n, 3)) + (0.0, 0.0, 2.0)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _photons(rng, blobs, background):
    pos = [rng.normal(c, s, (n, 3)) for c, n, s in blobs]
    pos.append(rng.uniform(-1.0, 1.0, (background, 3)))
    pos = np.concatenate(pos).astype(np.float32)
    col = rng.uniform(0, 1, pos.shape).astype(np.float32)
    return pos, _directions(rng, pos.shape[0]), col


def _jax_map(pos, d, col, dtype=jnp.float32, **kw):
    return jph.build_photon_map(
        jph.PhotonBatch(jnp.asarray(pos, dtype), jnp.asarray(d, dtype),
                        jnp.asarray(col, dtype),
                        jnp.ones(pos.shape[0], bool)),
        -np.ones(3), np.ones(3), **kw)


def _queries(rng):
    """Inside each blob, in the spread cluster, and over the whole box
    (mostly empty or sparse windows)."""
    q = np.concatenate([rng.normal((0.0, 0.0, 0.0), 2e-4, (128, 3)),
                        rng.normal((0.3, -0.2, 0.1), 2e-4, (256, 3)),
                        rng.normal(0.0, 0.2, (384, 3)),
                        rng.uniform(-1.0, 1.0, (256, 3))]).astype(np.float32)
    return q, _directions(rng, q.shape[0])


def _window_stats(pm, q):
    """(candidates, whether a cell past the cap is in the window) a query."""
    n = torch.zeros(q.shape[0], dtype=torch.int64)
    over = torch.zeros(q.shape[0], dtype=torch.bool)
    for start, end, dup in _window(pm, _cells(pm, q)):
        cnt = torch.where(dup, 0, end - start)
        n += cnt
        over |= cnt > pm.window_cap
    return n.numpy(), over.numpy()


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(10)
    pos, d, col = _photons(rng, BLOBS, BACKGROUND)
    jpm = _jax_map(pos, d, col, max_cells=MAX_CELLS)
    tpm = port_map(jpm)
    occ = int(np.diff(np.asarray(jpm.cell_start)).max())
    assert jpm.window_cap == 96 and occ > jpm.window_cap   # the cap binds
    q, qd = _queries(rng)
    return jpm, tpm, q, qd


def _close(got, want):
    return (np.abs(got - want) <= 1e-6 + 2e-4 * np.abs(want)).all(-1)


def test_whole_window_matches_jax_perpoint(case):
    jpm, tpm, q, qd = case
    n, over = _window_stats(tpm, torch.from_numpy(q))
    exact = n <= TIER_CAPS[-1]
    assert (exact & over).sum() >= 100, (exact & over).sum()
    want = np.asarray(_fwd_perpoint(jpm, jnp.asarray(q), jnp.asarray(qd), K,
                                    interpret=True))
    got = sample_photons_tiled(tpm, torch.from_numpy(q),
                               torch.from_numpy(qd), K).numpy()
    assert (np.abs(want[exact & over]).sum(-1) > 0).all()
    close = _close(got, want)[exact]
    assert close.mean() >= 0.999, (close.mean(), (~close).sum())


def _oracle(tpm, q, qd, k):
    """Float64 brute force over each query's own window: the photons whose
    cell (from the map's cell ranges) is within one cell of the query's on
    every axis; the k nearest, or all of them when fewer, and r_k^2 the
    largest of those d^2."""
    nx, ny, nz = tpm.dims
    cs = tpm.cell_start.numpy()
    cid = np.repeat(np.arange(cs.shape[0] - 1), np.diff(cs))
    pcell = np.stack([cid // (ny * nz), (cid // nz) % ny, cid % nz], 1)
    pos = tpm.pos.numpy().astype(np.float64)[:cid.shape[0]]
    pdir = tpm.dir.numpy().astype(np.float64)[:cid.shape[0]]
    pcol = tpm.col.numpy().astype(np.float64)[:cid.shape[0]]
    qcell = _cells(tpm, torch.from_numpy(q)).numpy()
    out = np.zeros((q.shape[0], 3))
    for i in range(q.shape[0]):
        inw = (np.abs(pcell - qcell[i]) <= 1).all(1)
        if not inw.any():
            continue
        d2 = ((pos[inw] - q[i].astype(np.float64)) ** 2).sum(1)
        sel = np.argsort(d2)[:k]
        w = pdir[inw][sel] @ qd[i].astype(np.float64)
        out[i] = (pcol[inw][sel] * w[:, None]).sum(0) / (np.pi * d2[sel[-1]])
    return out


def test_every_window_matches_float64_oracle(case):
    _, tpm, q, qd = case
    n, _ = _window_stats(tpm, torch.from_numpy(q))
    assert (n > TIER_CAPS[-1]).sum() >= 100 and (n == 0).sum() >= 10
    got = sample_photons_tiled(tpm, torch.from_numpy(q),
                               torch.from_numpy(qd), K).numpy()
    np.testing.assert_allclose(got, _oracle(tpm, q, qd, K), rtol=5e-3,
                               atol=1e-4)


def test_plain_matches_float64_oracle_past_30k_candidates():
    """The plain version, which the card's gates hold K3's focal tier to,
    against the float64 oracle at a near-point focus of 32,000 photons
    that no grid of the cell budget splits: windows of more than 30,000
    candidates, the size a focal block stages in shared memory."""
    rng = np.random.default_rng(13)
    at = (0.1, -0.1, 0.2)
    pos, d, col = _photons(rng, ((at, 32_000, 1e-4),), 2000)
    pm = tph.build_photon_map(
        tph.PhotonBatch(*(torch.from_numpy(a) for a in (pos, d, col)),
                        torch.ones(pos.shape[0], dtype=torch.bool)),
        -np.ones(3), np.ones(3), max_cells=4096)
    q = np.concatenate([rng.normal(at, 2e-4, (48, 3)),
                        rng.uniform(-1.0, 1.0, (16, 3))]).astype(np.float32)
    qd = _directions(rng, q.shape[0])
    n, _ = _window_stats(pm, torch.from_numpy(q))
    assert (n[:48] > 30_000).all()
    got = sample_photons_tiled(pm, torch.from_numpy(q),
                               torch.from_numpy(qd), K).numpy()
    assert (np.abs(got[:48]).sum(-1) > 0).all()
    np.testing.assert_allclose(got, _oracle(pm, q, qd, K), rtol=5e-3,
                               atol=1e-4)


def test_jnp_backend_equals_jax_capped_estimator(case):
    jpm, tpm, q, qd = case
    want = np.asarray(jph.sample_photons(jpm, jnp.asarray(q),
                                         jnp.asarray(qd), K))
    tq, tqd = torch.from_numpy(q), torch.from_numpy(qd)
    got = tph.sample_photons_backend(tpm, tq, tqd, K, "jnp").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    # the cap matters on these queries: the whole window differs
    _, over = _window_stats(tpm, tq)
    whole = tph.sample_photons_backend(tpm, tq, tqd, K, "auto").numpy()
    assert (~_close(got, whole)[over]).mean() > 0.5
    for backend in ("pallas", "chunkrow"):
        assert np.array_equal(
            tph.sample_photons_backend(tpm, tq, tqd, K, backend).numpy(),
            whole)
    with pytest.raises(ValueError):
        tph.sample_photons_backend(tpm, tq, tqd, K, "tiled")


def test_whole_window_gradcheck_under_a_binding_cap():
    """torch.autograd.gradcheck (float64) of the estimate with respect to
    the query points and the photon colours, on queries whose windows hold
    a cell past the cap."""
    rng = np.random.default_rng(11)
    pos, d, col = _photons(rng, (((0.2, 0.1, -0.1), 250, 1e-2),), 150)
    batch = tph.PhotonBatch(*(torch.from_numpy(a.astype(np.float64))
                              for a in (pos, d, col)),
                            torch.ones(pos.shape[0], dtype=torch.bool))
    pm = tph.build_photon_map(batch, -np.ones(3), np.ones(3),
                              max_cells=4096)
    q = torch.from_numpy(np.concatenate([
        rng.normal((0.2, 0.1, -0.1), 1e-2, (4, 3)),
        rng.uniform(-1.0, 1.0, (2, 3))]))
    qd = torch.from_numpy(_directions(rng, 6).astype(np.float64))
    _, over = _window_stats(pm, q)
    assert over[:4].all()
    assert int((pm.cell_start[1:] - pm.cell_start[:-1]).max()) \
        > pm.window_cap

    def f(point, c):
        return sample_photons_tiled(dataclasses.replace(pm, col=c), point,
                                    qd, 8)

    assert torch.autograd.gradcheck(
        f, (q.clone().requires_grad_(), pm.col.clone().requires_grad_()))


def test_whole_window_grads_match_jax_tiled():
    """Gradients with respect to the photon colours and the query points
    equal jax.grad through JAX ``sample_photons_tiled`` (interpret), whose
    custom VJP differentiates the chunk-row path: exact here, where every
    window fits 16 chunk rows of 32 photons, the path's small bucket
    (float32; rtol 5e-3, atol 1e-5, as tests/test_photon_knn.py holds the
    JAX tiled VJP)."""
    rng = np.random.default_rng(12)
    pos, d, col = _photons(rng, (((0.2, 0.1, -0.1), 150, 1e-4),
                                 ((0.0, 0.0, 0.0), 800, 0.3)), 200)
    jpm = _jax_map(pos, d, col, max_cells=4096)
    tpm = port_map(jpm)
    q = np.concatenate([rng.normal((0.2, 0.1, -0.1), 2e-4, (8, 3)),
                        rng.normal(0.0, 0.3, (24, 3))]).astype(np.float32)
    qd = _directions(rng, q.shape[0])
    _, over = _window_stats(tpm, torch.from_numpy(q))
    assert over[:8].all()
    assert int(_window_runs(jpm, jnp.asarray(q))[3].max()) <= 16

    def jloss(c, qq):
        return jnp.sum(jax_tiled(jpm.replace(col=c), qq, jnp.asarray(qd), 8,
                                 interpret=True) ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(jpm.col, jnp.asarray(q))
    c = tpm.col.clone().requires_grad_(True)
    pt = torch.from_numpy(q).requires_grad_(True)
    est = sample_photons_tiled(dataclasses.replace(tpm, col=c), pt,
                               torch.from_numpy(qd), 8)
    got = torch.autograd.grad(torch.sum(est ** 2), (c, pt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3,
                                   atol=1e-5)
    assert (got[0].abs() > 0).any() and (got[1][:8].abs() > 0).all()
