"""The wave-inputs kernel's host side on the CPU: the packed permutation
table and per-dim plan the kernel reads (against
``HaltonSampler.arith_plan``, and the kernel's digit loop run from them in
numpy against ``HaltonSampler.sample``).  The reasons that send a wave's
set-up to the torch route are ``tests/test_torch_routes.py``'s; the kernel
itself is held to its plain version on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from gi_raytracer_tpu_torch.ops.cuda_wave_inputs import MAX_DEPTH, dim_plan
from gi_raytracer_tpu_torch.sampling.halton import (ARITH_FIRST,
                                                    ARITH_MAX_PRIME,
                                                    ARITH_PRIMES, PRIMES,
                                                    HaltonSampler)

M32 = 0xFFFFFFFF


def test_the_arithmetic_range_ends_past_depth_16():
    """Dims 0 ... 1 + 2 ``MAX_DEPTH`` have bases up to 139; the next
    bounce's would reach 151, past ``ARITH_MAX_PRIME``."""
    assert len(ARITH_PRIMES) == 35 and sum(ARITH_PRIMES) == 2276
    assert PRIMES[1 + 2 * MAX_DEPTH] == 139
    assert PRIMES[3 + 2 * MAX_DEPTH] == 151 > ARITH_MAX_PRIME


@pytest.mark.parametrize("scramble", ["faure", "random"])
@pytest.mark.parametrize("index_bits", [22, 24])
def test_packed_table_and_plan_match_arith_plan(scramble, index_bits):
    """Every odd base up to 150: its slice of the uint8 table is its digit
    permutation, and its row of the plan is ``arith_plan``'s digits, tail
    and float32 scale."""
    s = HaltonSampler(scramble, seed=5)
    table = s.arith_perms("cpu").numpy()
    assert table.dtype == np.uint8 and table.shape == (2276,)
    assert s.arith_perms("cpu") is s.arith_perms("cpu")    # uploaded once
    # base 2 (dim 0, a bit reversal) reads none: its entries are the
    # identity
    np.testing.assert_array_equal(table[:2], [0, 1])
    for p in ARITH_PRIMES[1:]:
        perm = s.arith_plan(p, index_bits)[0]
        np.testing.assert_array_equal(
            table[ARITH_FIRST[p]:ARITH_FIRST[p] + p], perm)
    plan = dim_plan(s, MAX_DEPTH, index_bits)
    assert plan.dtype == np.uint32 and plan.shape == (1 + 2 * MAX_DEPTH, 6)
    for dim, (p, first, digits, shift, tail, bits) in enumerate(plan, 1):
        perm, needed, extra, scale = s.arith_plan(int(p), index_bits)
        assert (p, first, digits) == (PRIMES[dim], ARITH_FIRST[p], needed)
        assert shift == (int(p) ** extra) & M32
        assert tail == (int(perm[0]) * sum(int(p) ** k
                                           for k in range(extra))) & M32
        assert np.uint32(bits).view(np.float32) == scale
    assert dim_plan(s, 3, index_bits).tolist() == plan[:7].tolist()


def _kernel_dims(s, idx, depth, index_bits):
    """The kernel's evaluation of dims 0 ... 1 + 2 ``depth`` in numpy
    uint32, from the packed table and plan alone."""
    table = s.arith_perms("cpu").numpy().astype(np.uint32)
    h = idx.astype(np.uint32)
    rev = np.zeros_like(h)
    for b in range(32):
        rev |= ((h >> np.uint32(b)) & np.uint32(1)) << np.uint32(31 - b)
    out = [((rev >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
           - np.float32(1.0)]
    for base, first, digits, shift, tail, bits in dim_plan(s, depth,
                                                           index_bits):
        acc = np.zeros_like(h)
        div = h.copy()
        for _ in range(int(digits)):
            q = div // base
            acc = acc * base + table[first + (div - q * base)]
            div = q
        acc = acc * shift + tail
        out.append(acc.astype(np.float32) * np.uint32(bits).view(np.float32))
    return out


@pytest.mark.parametrize("scramble", ["faure", "random"])
@pytest.mark.parametrize("index_bits", [22, 24])
def test_kernel_digit_loop_from_the_plan_equals_sample(scramble, index_bits):
    """The kernel's digit loop run from the packed table and plan gives
    ``HaltonSampler.sample`` bit for bit in every dim of depth 16, on
    indices inside the index bits and past them, up to the uint32 wrap."""
    s = HaltonSampler(scramble, seed=9)
    rng = np.random.default_rng(index_bits)
    idx = np.concatenate([rng.integers(0, 1 << index_bits, 3000),
                          rng.integers(0, 1 << 32, 3000),
                          [0, 1, (1 << index_bits) - 1, M32]])
    with np.errstate(over="ignore"):
        got = _kernel_dims(s, idx, MAX_DEPTH, index_bits)
    t_idx = torch.as_tensor(idx.astype(np.int64))
    for dim, g in enumerate(got):
        want = s.sample(dim, t_idx, index_bits).numpy()
        np.testing.assert_array_equal(g.view(np.uint32),
                                      want.view(np.uint32), err_msg=str(dim))
