"""Port parity of ``photon_knn.py:71`` ``_knn_kernel``: the JAX per-point
kNN (``_fwd_perpoint``: exact ragged windows, tiers of <= 128, 512 and
2,048 candidates, past 2,048 the capped reference estimator) in interpret
mode, against the port's whole-window plain version
(``sample_photons_plain``, which K3 computes on the card) on one photon
map and one set of queries.

The map is a dense core in a sparse background, on a grid whose densest
cell holds fewer photons than the window cap, so that JAX's capped
fallback past 2,048 candidates also counts the whole window and every
tier is comparable.  (Where a cell holds more than the cap:
tests/test_torch_knn_window.py.)"""

import numpy as np
import jax.numpy as jnp
import torch

from gi_raytracer_tpu.render.photon import (PhotonBatch as JaxBatch,
                                            build_photon_map as jax_build_map)
from gi_raytracer_tpu.render.photon_knn import TIER_CAPS, _fwd_perpoint
from gi_raytracer_tpu_torch.render.photon_knn import (_cells, _window,
                                                      sample_photons_plain)

from _torch_parity import port_map

K = 32


def test_perpoint_knn_matches_port_plain_in_every_tier():
    rng = np.random.default_rng(8)
    pos = np.concatenate([rng.uniform(-0.25, 0.25, (20_000, 3)),
                          rng.uniform(-1.0, 1.0, (6_000, 3))]) \
        .astype(np.float32)
    P = pos.shape[0]
    d = rng.normal(size=(P, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    col = rng.uniform(0, 1e-3, (P, 3)).astype(np.float32)
    jpm = jax_build_map(JaxBatch(jnp.asarray(pos), jnp.asarray(d),
                                 jnp.asarray(col), jnp.ones(P, bool)),
                        -np.ones(3), np.ones(3), target_per_cell=1.8,
                        window_cap=256)
    tpm = port_map(jpm)
    occ = np.diff(np.asarray(jpm.cell_start)).max()
    assert occ < jpm.window_cap                   # the cap never binds

    q = rng.uniform(-0.35, 0.35, (1024, 3)).astype(np.float32)
    qd = rng.normal(size=(1024, 3)).astype(np.float32)
    qd /= np.linalg.norm(qd, axis=1, keepdims=True)
    tq = torch.from_numpy(q)
    n_cand = torch.zeros(1024, dtype=torch.int64)
    for start, end, dup in _window(tpm, _cells(tpm, tq)):
        n_cand += torch.where(dup, 0, end - start)
    bounds = (0,) + TIER_CAPS + (1 << 30,)
    tiers = [int(((n_cand > lo) & (n_cand <= hi)).sum())
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    assert min(tiers) >= 20, tiers                 # every tier is exercised
    assert (n_cand > K).float().mean() > 0.5

    want = np.asarray(_fwd_perpoint(jpm, jnp.asarray(q), jnp.asarray(qd), K,
                                    interpret=True))
    got = sample_photons_plain(tpm, tq, torch.from_numpy(qd), K).numpy()
    assert (np.abs(want).sum(-1) > 0).mean() > 0.9
    close = (np.abs(got - want) <= 1e-6 + 2e-4 * np.abs(want)).all(-1)
    assert close.mean() >= 0.999, close.mean()
