"""Counter-based uniforms, bit-exact with ``gi_raytracer_tpu.sampling.rng``.

torch has no general ``uint32`` arithmetic, so every uint32 value is held
in an ``int64`` tensor in [0, 2**32) and every operation is reduced
``& 0xFFFFFFFF``.  Products are split into 16-bit halves so no
intermediate leaves the int64 range.  The result keeps the reference's
top-24-bit -> int32 -> float32 conversion, so the CUDA kernels (which use
native ``uint32``) and this module give the same bits.

The threefry streams (``PRNGKey``, ``fold_in``, ``stream``, ``uniform``)
are ``jax.random``'s, bit for bit, with ``jax_threefry_partitionable`` on
(the default of JAX 0.5 and later) and 64-bit seeds (``jax_enable_x64``):
a key is a pair of Python ints, and ``uniform`` draws on the device.  The
threefry rounds are written once for Python ints and int64 tensors alike.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .. import telemetry

M32 = 0xFFFFFFFF


class Purpose(enum.IntEnum):
    """Stable stream ids for every stochastic decision in the renderer."""
    LIGHT_POINT_X = 1
    LIGHT_POINT_Y = 2
    RUSSIAN_ROULETTE = 3
    RAY_TYPE_OPACITY = 4
    RAY_TYPE_FRESNEL = 5
    ALPHA_TEST = 6
    FOG_MARCH = 7
    PHOTON_EMIT_X = 8
    PHOTON_EMIT_Y = 9
    PHOTON_ALPHA = 10
    DEEP_DIM_X = 11
    DEEP_DIM_Y = 12
    FOG_DIR_X = 13
    FOG_DIR_Y = 14


def u32(x, device=None) -> torch.Tensor:
    """A uint32 value (int, int32 bit pattern or int64) as int64 in
    [0, 2**32)."""
    if not isinstance(x, torch.Tensor):
        with telemetry.sync("rng.u32"):     # a copy to the card waits
            x = torch.as_tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & M32


def mul32(a, c: int):
    """(a * c) mod 2**32 for a in [0, 2**32) (an int64 tensor or a Python
    int) and a constant c."""
    c &= M32
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mix(h):
    """Final avalanche of murmur3 on uint32 (an int64 tensor or a Python
    int)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _host(x) -> bool:
    return isinstance(x, (int, np.integer))


def hash_bits(a, b, c=0) -> torch.Tensor:
    """The uint32 hash behind :func:`hash_u01` (int64 in [0, 2**32)).

    Integer arguments are folded on the host with uint32 semantics (the
    same bits): ``_mix(c)`` where ``c`` is an int, and the whole
    ``_mix(((b + C) & M32) ^ _mix(c))`` where ``b`` is one too.  They
    enter the tensor arithmetic as one scalar, so such a call copies
    nothing to the card and waits for nothing.  Without a tensor argument
    the result is a CPU tensor."""
    dev = next((x.device for x in (a, b, c) if isinstance(x, torch.Tensor)),
               None)

    def word(x):
        return int(x) & M32 if _host(x) else u32(x, dev)

    bc = _mix(((word(b) + 0x7F4A7C15) & M32) ^ _mix(word(c)))
    h = _mix(mul32(word(a), 0x9E3779B9) ^ bc)
    return h if isinstance(h, torch.Tensor) else torch.tensor(h)


def bits_to_u01(h: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> float32 in [0, 1)."""
    return (h >> 8).to(torch.int32).to(torch.float32) * 5.960464477539063e-08


def hash_u01(a, b, c=0) -> torch.Tensor:
    """Uniform in [0,1) from integer coordinates (vectorized, float32)."""
    return bits_to_u01(hash_bits(a, b, c))


# ---- threefry-2x32 (jax.random's PRNG) ------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """The threefry-2x32 block of key (k0, k1) on counters (x0, x1): Python
    ints or int64 tensors holding uint32 values.  Returns the two output
    words, as JAX's ``threefry2x32_p`` does (20 rounds, 5 key
    injections)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def PRNGKey(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` for a 64-bit seed: its high and low
    words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32, seed & M32)


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in``: the key's threefry block on (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def stream(key: tuple, *ids: int) -> tuple:
    """The key of a (wave, bounce, purpose, ...) tuple: one ``fold_in``
    per id, as ``gi_raytracer_tpu.sampling.rng.stream``."""
    for i in ids:
        key = fold_in(key, i)
    return key


def uniform(key: tuple, shape, dtype=torch.float32,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` in [0, 1) on ``device``.

    The counters are the flat element index (the partitionable layout:
    high word 0 below 2**32 elements).  float32 takes the xor of the two
    output words and keeps its top 23 bits as the mantissa of a float in
    [1, 2); float64 takes both words as one 64-bit value and keeps its top
    52 bits."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= int(d)
    if n > M32:
        raise ValueError(f"{n} draws: past the 32-bit counter")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    if dtype == torch.float64:
        mant = ((b0 << 20) | (b1 >> 12)) & ((1 << 52) - 1)
        out = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    elif dtype == torch.float32:
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        out = bits.to(torch.int32).view(torch.float32) - 1.0
    else:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    return out.reshape(shape)


class ThreefryUniform:
    """Default emission uniforms: the JAX emission's threefry key path
    (``fold_in(key, chunk)``, then ``fold_in(., round)``; the direction
    from ``stream(., PHOTON_EMIT_X, li)``, a chain step's BSDF uniforms
    from ``fold_in(stream(., PHOTON_ALPHA, li), depth)``), drawn on
    ``device``.  A draw depends on its key alone, never on call order."""

    def __init__(self, seed: int, device):
        self.key = PRNGKey(seed)
        self.device = torch.device(device)

    def key_of(self, li, chunk, rnd, depth) -> tuple:
        """The key of a draw (depth -1: the emission direction)."""
        kr = fold_in(fold_in(self.key, chunk), rnd)
        if depth < 0:
            return stream(kr, Purpose.PHOTON_EMIT_X, li)
        return fold_in(stream(kr, Purpose.PHOTON_ALPHA, li), depth)

    def __call__(self, li, chunk, rnd, depth, shape, dtype=torch.float32):
        return uniform(self.key_of(li, chunk, rnd, depth), shape, dtype,
                       self.device)

    def round_keys(self, li, chunk, rounds: int, depth: int) -> np.ndarray:
        """(rounds, 1 + depth, 2) uint32: ``key_of(li, chunk, r, d)`` at
        [r, d + 1] for d from -1 to depth - 1, the keys the round kernel
        draws with, for every round of a chunk at once (the threefry blocks
        on numpy arrays of the rounds)."""
        def fold(key, data):
            return threefry2x32(key[0], key[1], 0, data & M32)

        kc = fold_in(self.key, chunk)
        kr = fold(kc, np.arange(rounds, dtype=np.int64))
        emit = fold(fold(kr, Purpose.PHOTON_EMIT_X), li)
        alpha = fold(fold(kr, Purpose.PHOTON_ALPHA), li)
        keys = [emit] + [fold(alpha, d) for d in range(depth)]
        return np.stack([np.stack(k, -1) for k in keys], 1).astype(np.uint32)
