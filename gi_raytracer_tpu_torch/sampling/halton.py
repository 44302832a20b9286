"""Scrambled-Halton QMC engine, bit-exact with
``gi_raytracer_tpu.sampling.halton``.

Host tables (Faure permutations, digit tables, the pixel enumeration) are
numpy, as in the JAX package; the per-lane arithmetic is torch on int64
holding uint32 values (see ``rng``).  Both evaluation strategies produce
the reference's uint32 accumulator:

* arithmetic (primes <= ARITH_MAX_PRIME): per-digit divide/modulo.  The
  JAX package evaluates the digit permutation as a compare-select chain
  (a TPU vector-unit trick); here it is a gather from the same
  permutation, which yields the identical integer.
* table (larger primes): chunk-wise lookups through the baked tables.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import telemetry
from .rng import M32, mul32


def _first_primes(n: int) -> tuple:
    ps, c = [], 2
    while len(ps) < n:
        if all(c % p for p in ps if p * p <= c):
            ps.append(c)
        c += 1
    return tuple(ps)


PRIMES = _first_primes(256)
MAX_QMC_DIMS = len(PRIMES)
ARITH_MAX_PRIME = 150
ARITH_PRIMES = tuple(p for p in PRIMES if p <= ARITH_MAX_PRIME)
# each base's first entry in ``HaltonSampler.arith_perms``' table
ARITH_FIRST = dict(zip(ARITH_PRIMES,
                       np.cumsum((0,) + ARITH_PRIMES[:-1]).tolist()))
_SCALE_EPS = 0.9999998807907104   # keeps results strictly in [0,1)


def faure_permutations(max_base: int) -> list:
    """Faure digit permutations for every base up to ``max_base``."""
    perms = [None] * (max_base + 1)
    for k in range(1, min(3, max_base) + 1):
        perms[k] = np.arange(k, dtype=np.uint16)
    for base in range(4, max_base + 1):
        b = base // 2
        if base & 1:
            prev = perms[base - 1]
            p = np.empty(base, dtype=np.uint16)
            vals = prev + (prev >= b)
            idx = np.arange(base - 1)
            p[idx + (idx >= b)] = vals
            p[b] = b
        else:
            half = perms[b].astype(np.uint16)
            p = np.empty(base, dtype=np.uint16)
            p[:b] = 2 * half
            p[b:] = 2 * half + 1
        perms[base] = p
    return perms


def _table_digits(p: int) -> int:
    k = 1
    while p ** (k + 1) <= 361:
        k += 1
    return k


def _total_chunks(p: int, k: int) -> int:
    d = 1
    while p ** (d + 1) <= 0xFFFFFFFF:
        d += 1
    return d // k


def _build_table(p: int, perm: np.ndarray, k: int) -> np.ndarray:
    size = p ** k
    i = np.arange(size, dtype=np.uint64)
    out = np.zeros(size, dtype=np.uint64)
    rem = i.copy()
    for _ in range(k):
        out = out * p + perm[rem % p]
        rem //= p
    return out.astype(np.uint32)


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    x = ((x << 16) | (x >> 16)) & M32
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    return x


def halton2(index: torch.Tensor) -> torch.Tensor:
    """Base-2 radical inverse via bit reversal into a float mantissa."""
    bits = 0x3F800000 | (_reverse_bits32(index) >> 9)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _as_index(index) -> torch.Tensor:
    if not isinstance(index, torch.Tensor):
        index = torch.as_tensor(np.asarray(index, np.int64))
    return index.to(torch.int64) & M32


def scramble_permutations(scramble: str, seed=None) -> list:
    """The digit permutation of every base up to the largest prime:
    ``faure``; ``random`` (``numpy.random.default_rng(seed)`` shuffling
    every base above 3 in turn, as the JAX package does, so the tables
    are its tables); or ``none`` (the identity)."""
    max_base = PRIMES[-1]
    if scramble == "faure":
        return faure_permutations(max_base)
    if scramble == "random":
        gen = np.random.default_rng(seed)
        perms = [None] * (max_base + 1)
        for b in range(1, max_base + 1):
            p = np.arange(b, dtype=np.uint16)
            if b > 3:
                gen.shuffle(p)
            perms[b] = p
        return perms
    if scramble == "none":
        return [np.arange(b, dtype=np.uint16) for b in range(max_base + 1)]
    raise ValueError(f"unknown scramble: {scramble}")


class HaltonSampler:
    """``sample(dim, index)``: float32 samples in [0, 1) for a uint32
    index tensor (held as int64), matching the reference's sampler with
    the ``scramble`` digit permutations (``scramble_permutations``)."""

    def __init__(self, scramble: str = "faure", seed: int | None = None):
        self._perms = scramble_permutations(scramble, seed)
        self._tables: dict[int, np.ndarray] = {}
        self._meta: dict[int, tuple] = {}
        for p in PRIMES[1:]:
            k = _table_digits(p)
            c = _total_chunks(p, k)
            if p > ARITH_MAX_PRIME:
                self._tables[p] = _build_table(p, self._perms[p], k)
            self._meta[p] = (k, c, _SCALE_EPS / float(p ** (k * c)))
        self._dev_cache: dict = {}

    def _dev(self, name, p, arr, device):
        key = (name, p, device)
        if key not in self._dev_cache:
            with telemetry.sync("halton.table"):
                self._dev_cache[key] = torch.as_tensor(
                    np.asarray(arr, np.int64), device=device)
        return self._dev_cache[key]

    def _sample_table(self, p: int, index: torch.Tensor) -> torch.Tensor:
        k, c, scale = self._meta[p]
        table = self._dev("table", p, self._tables[p], index.device)
        chunk = p ** k
        acc = torch.zeros_like(index)
        div = index
        for i in range(c):
            digits = table[div % chunk]
            acc = (acc + digits * ((p ** (k * (c - 1 - i))) & M32)) & M32
            if i + 1 < c:
                div = div // chunk
        return acc.to(torch.float32) * np.float32(scale)

    def arith_plan(self, p: int, index_bits: int = 32) -> tuple:
        """(digit permutation, digits evaluated, digits past them, float32
        scale) of base ``p``'s per-digit evaluation (``p`` at most
        ``ARITH_MAX_PRIME``): the digits an index of ``index_bits`` bits
        can set, and the count of the always-zero digits past them, whose
        permuted values ``_sample_arith`` adds as one tail."""
        k, c, scale = self._meta[p]
        K = k * c
        needed = 1
        while needed < K and p ** needed < (1 << index_bits):
            needed += 1
        return self._perms[p], needed, K - needed, np.float32(scale)

    def arith_perms(self, device=None) -> torch.Tensor:
        """The digit permutations of every base in ``ARITH_PRIMES``, one
        after another (base p's from ``ARITH_FIRST[p]``), as a uint8 tensor
        on ``device``, uploaded once: the table the wave-inputs kernel
        reads."""
        key = ("arith_perms", torch.device(device or "cpu"))
        if key not in self._dev_cache:
            table = np.concatenate([self._perms[p] for p in ARITH_PRIMES])
            with telemetry.sync("halton.table"):
                self._dev_cache[key] = torch.as_tensor(
                    table.astype(np.uint8), device=device)
        return self._dev_cache[key]

    def _sample_arith(self, p: int, index: torch.Tensor,
                      index_bits: int) -> torch.Tensor:
        _, needed, extra, scale = self.arith_plan(p, index_bits)
        perm = self._dev("perm", p, self._perms[p], index.device)
        acc = torch.zeros_like(index)
        div = index
        for j in range(needed):
            acc = (acc * p + perm[div % p]) & M32
            if j + 1 < needed:
                div = div // p
        if extra:
            shift = (p ** extra) & M32
            tail = (int(self._perms[p][0]) * ((p ** extra - 1) // (p - 1))) & M32
            acc = (mul32(acc, shift) + tail) & M32
        return acc.to(torch.float32) * scale

    def sample(self, dim: int, index, index_bits: int = 32) -> torch.Tensor:
        if not (0 <= dim < MAX_QMC_DIMS):
            raise ValueError(f"dim {dim} outside QMC range [0,{MAX_QMC_DIMS})")
        index = _as_index(index)
        if dim == 0:
            return halton2(index)
        p = PRIMES[dim]
        if p <= ARITH_MAX_PRIME:
            return self._sample_arith(p, index, index_bits)
        return self._sample_table(p, index)


class HaltonEnum:
    """Pixel-stratified Halton index enumeration: ``index(i, x, y) =
    offsets[y, x] + i * increment`` (host numpy offsets)."""

    def __init__(self, width: int, height: int):
        if width <= 0 or height <= 0:
            raise ValueError(f"image size {width}x{height}")
        self.width, self.height = width, height
        p2, w = 0, 1
        while w < width:
            p2, w = p2 + 1, w * 2
        p3, h = 0, 1
        while h < height:
            p3, h = p3 + 1, h * 3
        self.scale_x = float(w)
        self.scale_y = float(h)
        self.increment = w * h
        inv2 = pow(h, -1, w) if w > 1 else 0
        inv3 = pow(w, -1, h) if h > 1 else 0
        self._mx = h * inv2
        self._my = w * inv3
        xs = np.arange(width, dtype=np.uint64)
        hx = np.zeros_like(xs)
        rem = xs.copy()
        for _ in range(p2):
            hx = (hx << np.uint64(1)) | (rem & np.uint64(1))
            rem >>= np.uint64(1)
        ys = np.arange(height, dtype=np.uint64)
        hy = np.zeros_like(ys)
        rem = ys.copy()
        for _ in range(p3):
            hy = hy * np.uint64(3) + rem % np.uint64(3)
            rem //= np.uint64(3)
        off = (hx[None, :] * np.uint64(self._mx)
               + hy[:, None] * np.uint64(self._my)) % np.uint64(self.increment)
        self.offsets = off.astype(np.uint32)  # (H, W)

    @property
    def max_samples_per_pixel(self) -> int:
        return 0xFFFFFFFF // self.increment

    def get_index(self, i, x, y) -> torch.Tensor:
        """uint32 index (int64) of the i-th sample of pixel (x, y)."""
        i, x, y = (torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v).to(torch.int64) for v in (i, x, y))
        off = torch.as_tensor(self.offsets.astype(np.int64),
                              device=x.device)[y, x]
        return (off + mul32(i.to(x.device) & M32, self.increment)) & M32

    def index_image(self, i, device=None) -> torch.Tensor:
        """(H, W) uint32 indices (int64) for sample wave ``i``."""
        off = torch.as_tensor(self.offsets.astype(np.int64), device=device)
        return (off + int(i) * self.increment) & M32
