"""Low-discrepancy scalar and vector sequences beyond the Halton engine,
the counterpart of ``gi_raytracer_tpu.sampling.lowdisc`` on tensors of any
leading batch shape (uint32 values held in int64, as in ``rng``):

* ``radical_inverse_vdc``: base-2 Van der Corput by bit reversal.
* ``hammersley2d``: the (i/N, VdC(i)) point set.
* ``subrand``: the additive recurrence frac(start + (i+1) sqrt(prime)),
  in closed form.
* ``sphere_point`` and ``subrand_unit_vec``: uniform unit-sphere points,
  the latter driven by the Hammersley set.
* ``importance_sample_ggx``: the GGX (phi, theta) sample.
"""

from __future__ import annotations

import torch

from ..render.geom import PI
from .rng import M32

SUBRAND_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31)


def radical_inverse_vdc(bits) -> torch.Tensor:
    """Base-2 radical inverse by bit reversal, float32."""
    b = torch.as_tensor(bits).to(torch.int64) & M32
    b = ((b << 16) | (b >> 16)) & M32
    b = ((b & 0x55555555) << 1) | ((b & 0xAAAAAAAA) >> 1)
    b = ((b & 0x33333333) << 2) | ((b & 0xCCCCCCCC) >> 2)
    b = ((b & 0x0F0F0F0F) << 4) | ((b & 0xF0F0F0F0) >> 4)
    b = ((b & 0x00FF00FF) << 8) | ((b & 0xFF00FF00) >> 8)
    return b.to(torch.float32) * 2.3283064365386963e-10


def hammersley2d(i, n: int) -> torch.Tensor:
    """(..., 2) Hammersley points (i/N, VdC(i))."""
    i = torch.as_tensor(i)
    x = i.to(torch.float32) / torch.tensor(float(n), dtype=torch.float32)
    return torch.stack([x, radical_inverse_vdc(i).to(x.device)], dim=-1)


def subrand(n: int, start=0.0, prime_index: int = 0,
            device=None) -> torch.Tensor:
    """x_i = frac(start + (i+1) a), a = frac(sqrt(prime)), i < n."""
    p = torch.tensor(float(SUBRAND_PRIMES[prime_index % 11]),
                     dtype=torch.float32)
    a = torch.remainder(torch.sqrt(p), 1.0).to(device)
    i = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    s = torch.as_tensor(start, dtype=torch.float32, device=device)
    return torch.remainder(s + i * a, 1.0)


def sphere_point(x, y) -> torch.Tensor:
    """Uniform unit-sphere point from two uniforms: theta = acos(2y - 1),
    phi = 2 pi x."""
    theta = torch.arccos(torch.clamp(2.0 * y - 1.0, -1.0, 1.0))
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(2.0 * PI * x),
                        st * torch.sin(2.0 * PI * x),
                        torch.cos(theta)], dim=-1)


def subrand_unit_vec(n: int, device=None) -> torch.Tensor:
    """(n, 3) low-discrepancy unit-sphere points: ``sphere_point`` of the
    n-point Hammersley set."""
    h = hammersley2d(torch.arange(n, device=device), n)
    return sphere_point(h[..., 0], h[..., 1])


def importance_sample_ggx(x, y, a) -> torch.Tensor:
    """GGX importance sample -> (..., 2) of (phi, theta)."""
    x, y, a = (torch.as_tensor(v) for v in (x, y, a))
    phi = 2.0 * PI * x
    theta = torch.arccos(torch.sqrt((1.0 - y) / ((a * a - 1.0) * y + 1.0)))
    return torch.stack([phi, theta], dim=-1)
