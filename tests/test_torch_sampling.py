"""Port parity: counter hash and Halton QMC, bit-equal with the JAX package
(and the reference goldens in tests/golden/)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu.sampling import rng as jrng
from gi_raytracer_tpu.sampling import halton as jhalton
from gi_raytracer_tpu_torch.sampling import rng as trng
from gi_raytracer_tpu_torch.sampling import halton as thalton

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _u32(rng, n):
    return rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def samplers():
    return jhalton.HaltonSampler(), thalton.HaltonSampler()


def test_hash_u01_bit_equal():
    rng = np.random.default_rng(0)
    a, b, c = _u32(rng, 20000), _u32(rng, 20000), _u32(rng, 20000)
    # the high bits matter: ray ids past 2**31, purposes tagged 0x80000000
    a[:100] |= np.uint32(0x80000000)
    b[:100] = np.uint32(0x80000000) ^ np.arange(100, dtype=np.uint32)
    want = np.asarray(jrng.hash_u01(a, b, c))
    got = trng.hash_u01(_t(a), _t(b), _t(c)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ints with the high bit set (the decision tag, salts past 2**31), zero and
# the largest, negative int32 bit patterns
KEYS = [0, 1, 31337 * 7, 0x80000000 ^ 3, 0xFFFFFFFF, -5, np.uint32(0x9E3779B9)]


@pytest.mark.parametrize("b", KEYS + [None],
                         ids=[f"b{i}" for i in range(len(KEYS))] + ["b_tensor"])
def test_hash_u01_folds_int_keys(b):
    """``hash_bits``/``hash_u01`` with int ``b`` and ``c`` (the staged
    wave's decisions) and with int ``c`` alone (a tensor ``b``: the
    analytic passes) are bit-equal to the same call on tensors and to the
    JAX ``hash_u01``."""
    rng = np.random.default_rng(1)
    a = _u32(rng, 4096)
    a[:64] |= np.uint32(0x80000000)
    bt = _u32(rng, 4096) if b is None else None
    for c in KEYS:
        bj = bt if b is None else np.full(4096, np.uint32(int(b) & 0xFFFFFFFF))
        cj = np.full(4096, np.uint32(int(c) & 0xFFFFFFFF))
        want = np.asarray(jrng.hash_u01(a, bj, cj))
        bb = _t(bt) if b is None else b
        got = trng.hash_u01(_t(a), bb, c).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), c
        assert torch.equal(trng.hash_bits(_t(a), bb, c),
                           trng.hash_bits(_t(a), _t(bj), _t(cj)))


def test_hash_of_ints_alone_stays_a_cpu_tensor():
    """Without a tensor argument the hash is a CPU scalar tensor, equal to
    the one-element call on tensors."""
    for a, b, c in ((3, 0x80000001, 99), (0xFFFFFFFF, -1, 0x80000000)):
        got = trng.hash_bits(a, b, c)
        assert got.device.type == "cpu" and got.shape == ()
        want = trng.hash_bits(*(torch.tensor([x & 0xFFFFFFFF])
                                for x in (a, b, c)))
        assert int(got) == int(want[0])


def test_hash_with_int_keys_records_no_sync():
    """Under a profiler calls with int keys record no ``rng.u32`` sync
    span (nothing is copied to the device); an array key is still copied
    and marks it."""
    from torch.profiler import ProfilerActivity, profile

    from gi_raytracer_tpu_torch import telemetry
    a = torch.arange(64, dtype=torch.int64)
    telemetry.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            trng.hash_u01(a, 0x80000000 ^ 3, 31337)
            trng.hash_u01(a, a + 1, 0x80000000)
            trng.hash_u01(7, a, 5)
            n_folded = len(telemetry.records())
            trng.hash_u01(a, np.arange(64), 5)
        sites = [sp.attrs["site"] for sp in telemetry.records()
                 if sp.name == "sync"]
    finally:
        telemetry.reset()
    assert n_folded == 0
    assert sites == ["rng.u32"]


@pytest.mark.parametrize("dim", list(range(18)) + [31, 47, 100, 200, 255])
def test_halton_sample_bit_equal(samplers, dim):
    js, ts = samplers
    rng = np.random.default_rng(dim)
    idx = _u32(rng, 4096)
    for bits, ii in ((32, idx), (20, idx % np.uint32(1 << 20))):
        want = np.asarray(js.sample(dim, jnp.asarray(ii), bits))
        got = ts.sample(dim, _t(ii), bits).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
            (dim, bits)


@pytest.mark.parametrize("name", ["halton_golden.npz",
                                  "halton_hidim_golden.npz"])
def test_halton_matches_reference_golden(samplers, name):
    """The reference sampler's goldens, at the JAX test's tolerance (the
    bit-equality with the JAX sampler is the test above)."""
    _, ts = samplers
    g = np.load(os.path.join(GOLDEN, name))
    dims, idxs, vals = g["samples_dim"], g["samples_idx"], g["samples_val"]
    for d in np.unique(dims):
        m = dims == d
        got = ts.sample(int(d), _t(idxs[m])).numpy()
        np.testing.assert_allclose(got, vals[m], rtol=0, atol=2e-7,
                                   err_msg=f"dim {d}")
        if d == 0:   # pure bit manipulation: exact
            assert np.array_equal(got, vals[m])


@pytest.mark.parametrize("wh", [(32, 32), (37, 29), (512, 512)])
def test_halton_enum_index_image(wh):
    w, h = wh
    je, te = jhalton.HaltonEnum(w, h), thalton.HaltonEnum(w, h)
    assert (te.scale_x, te.scale_y, te.increment) == \
        (je.scale_x, je.scale_y, je.increment)
    for wave in (0, 3, 7):
        want = np.asarray(je.index_image(wave)).astype(np.int64)
        assert np.array_equal(te.index_image(wave).numpy(), want)
