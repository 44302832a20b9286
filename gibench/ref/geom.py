"""Frozen copy of ``gi_raytracer_tpu_torch/render/geom.py`` at commit
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0, kept so that the benchmark
never imports the program for its reference or its scenes.

Direction sampling and reflection math, vectorized over ray lanes.

Counterpart of ``gi_raytracer_tpu.render.geom``: the same formulas, term
for term, on torch tensors (cosine-power hemisphere, Phong lobe, spherical
cap, uniform sphere, refraction with total internal reflection, and the
branchless |z| tangent frame).
"""

from __future__ import annotations

import torch

PI = 3.141592653589793


def dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def normalize(v, eps=1e-300):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def reflect(i, n):
    """glm::reflect: i - 2*dot(n,i)*n."""
    return i - 2.0 * dot(n, i) * n


def refract_tir(inc, n, eta, eps=1e-5):
    """Refraction with fallback to reflection on TIR."""
    d = dot(n, inc)
    k = 1.0 - eta * eta * (1.0 - d * d)
    tir = k < eps
    refr = eta * inc - (eta * d + torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(tir, reflect(inc, n), refr)


def _frame_apply(axis, local):
    """Rotate ``local`` (z-up) into the frame of ``axis`` (the reference's
    branchless |z| construction)."""
    nx = axis[..., 0:1]
    ny = axis[..., 1:2]
    nz = axis[..., 2:3]
    z = torch.abs(nz)
    inv = 1.0 / (1.0 + z)
    c0 = torch.cat([z + ny * ny * inv, -nx * ny * inv, -nx], -1)
    c1 = torch.cat([-nx * ny * inv, z + nx * nx * inv, -ny], -1)
    c2 = torch.cat([nx, ny, z], -1)
    lx = local[..., 0:1]
    ly = local[..., 1:2]
    lz = local[..., 2:3]
    out = lx * c0 + ly * c1 + lz * c2
    flip = torch.cat([torch.ones_like(out[..., :2]),
                      torch.where(nz < 0, -torch.ones_like(lz),
                                  torch.ones_like(lz))], -1)
    return out * flip


def _cos_power_local(u, v, power):
    """z-up cosine-power sample; u, v (R,), power (R,) or scalar."""
    phi = v * (2.0 * PI)
    cos_t = torch.pow(torch.clamp(1.0 - u, min=0.0), 1.0 / power)
    sin2 = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
    pos = sin2 > 0
    sin_t = torch.where(pos, torch.sqrt(torch.where(pos, sin2, 1.0)), 0.0)
    cos_t = torch.broadcast_to(cos_t, sin_t.shape)
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                        cos_t], -1)


def hemisphere_cos(normal, u, v, power):
    return _frame_apply(normal, _cos_power_local(u, v, power))


def sample_phong(outdir, power, u, v):
    return _frame_apply(outdir, _cos_power_local(u, v, power))


def sphere_cap_cos(axis, u, v, power, frac):
    """Spherical-cap sample; the cap opening scales with ``frac``."""
    phi = v * (2.0 * PI)
    cos_t = frac * torch.pow(torch.clamp(1.0 - u, min=0.0), 1.0 / power) \
        + (1.0 - frac)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                         cos_t], -1)
    return _frame_apply(axis, local)


def random_unit_vec(x, y):
    """Uniform sphere direction from two uniforms."""
    z = torch.clamp(2.0 * y - 1.0, -1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([st * torch.cos(2.0 * PI * x),
                        st * torch.sin(2.0 * PI * x), z], -1)
