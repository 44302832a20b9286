"""The photon pass's round kernel's host side, on the CPU: the host's
threefry key schedule it is handed, Halton dim 1 as it evaluates it, and
the route each round's span names.  (The reasons it refuses a pass are
``tests/test_torch_routes.py``'s; the kernel itself runs on the card only:
``tests/test_torch_cuda.py`` holds it to the staged round.)"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gi_raytracer_tpu_torch import telemetry
from gi_raytracer_tpu_torch.config import RenderConfig
from gi_raytracer_tpu_torch.render import photon
from gi_raytracer_tpu_torch.sampling.halton import HaltonSampler
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
from gi_raytracer_tpu_torch.scene.cornell import cornell_box


@pytest.mark.parametrize("li, chunk", [(0, 0), (0, 5), (2, 1), (3, 17)])
def test_round_keys_follow_threefry_uniforms_key_path(li, chunk):
    """The keys handed to the kernel, every round's and depth's of a
    chunk at once, are ``ThreefryUniform``'s key path, whose draws are
    those of ``__call__``."""
    u = photon.ThreefryUniform(2876543219, "cpu")
    depth, rounds = 5, 64
    keys = u.round_keys(li, chunk, rounds, depth)
    assert keys.shape == (rounds, 1 + depth, 2) and keys.dtype == np.uint32
    for rnd in range(rounds):
        for d in range(-1, depth):
            assert tuple(int(k) for k in keys[rnd, d + 1]) == \
                u.key_of(li, chunk, rnd, d), (rnd, d)
    from gi_raytracer_tpu_torch.sampling import rng
    for d in (-1, depth - 1):
        assert torch.equal(u(li, chunk, 9, d, (4, 33)),
                           rng.uniform(tuple(int(k) for k in keys[9, d + 1]),
                                       (4, 33)))


@pytest.mark.parametrize("scramble, seed", [("faure", None), ("random", 3),
                                            ("none", None)])
def test_halton_dim1_as_the_kernel_evaluates_it(scramble, seed):
    """Halton dim 1 from ``arith_plan(3)`` as the kernel evaluates it
    (uint32 digits, the accumulator rounded to float32 and scaled) equals
    the sampler's, on the photon pass's indices slot * 64 + round."""
    s = HaltonSampler(scramble, seed)
    perm, digits, extra, scale = s.arith_plan(3)
    assert extra == 0 and scale.dtype == np.float32
    slot = np.arange(0, 750_000, 997, dtype=np.int64)
    idx = ((slot[:, None] * 64 + np.arange(0, 64, 7)) & 0xFFFFFFFF).ravel()
    acc = np.zeros_like(idx)
    div = idx.copy()
    for _ in range(digits):
        acc = acc * 3 + np.asarray(perm, np.int64)[div % 3]
        div //= 3
    want = s.sample(1, torch.as_tensor(idx.astype(np.int64))).numpy()
    assert np.array_equal(acc.astype(np.float32) * scale, want)


@pytest.fixture(scope="module")
def small_box():
    return cornell_box(SceneBuilder, meshgen, False).build(device="cpu")


def test_cpu_rounds_are_staged_and_recorded(small_box):
    """On the CPU every round is staged, the pass's spans are recorded
    under a profiler and not without one, and the table names the
    route."""
    cfg = RenderConfig(photons=300, ray_chunk=128, seed=3, photon_retries=4)
    telemetry.reset()
    off = photon.trace_photons(small_box, cfg)
    assert telemetry.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = photon.trace_photons(small_box, cfg)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    rounds = [sp for sp in telemetry.records() if sp.name == "photons.round"]
    assert rounds and {sp.attrs["route"] for sp in rounds} == {"staged"}
    table = telemetry.report(telemetry.records(), [])
    assert any(line.split()[:2] == ["photons.round[staged]",
                                    str(len(rounds))] for line in table)
    telemetry.reset()
    photon.trace_photons(small_box, cfg)
    assert telemetry.records() == []


def test_explicit_default_sources_give_the_default_batch(small_box):
    """A pass given the default sampler and uniform source, as the round
    kernel takes them, traces the batch of one given neither."""
    cfg = RenderConfig(photons=200, ray_chunk=64, seed=9, photon_retries=4)
    a = photon.trace_photons(small_box, cfg)
    b = photon.trace_photons(small_box, cfg, sampler=HaltonSampler(),
                             uniform=photon.ThreefryUniform(9, "cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
