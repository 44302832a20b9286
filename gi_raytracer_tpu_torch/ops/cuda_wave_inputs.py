"""A wave's set-up in one launch: wrapper of ``csrc/wave_inputs.cu``.

One launch draws every Halton dim of a render wave (dim 0 by bit reversal,
dims 1 ... 1 + 2 ``depth`` by the per-digit loop of the arithmetic range)
and its primary rays, bit-equal to ``Renderer.wave_inputs_plain``
(``HaltonSampler.sample`` of each dim and ``camera.primary_rays``).  The
caller takes it where ``routes.wave_inputs`` names the kernel and the
plain version everywhere else, so this module has no plain version of its
own and raises on anything but CUDA tensors.

:func:`dim_plan` packs each dim's evaluation (``HaltonSampler.arith_plan``)
for the kernel; :func:`wave_launcher` checks a renderer's tables once and
returns its launch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from ..sampling.halton import ARITH_FIRST, ARITH_MAX_PRIME, PRIMES

MAX_DEPTH = 16      # 2 + 2 * 16 dims: the last of base 139, the next 151
PLAN_WORDS = 6      # a dim's base, first entry, digits, shift, tail, scale


def dim_plan(sampler, depth: int, index_bits: int) -> np.ndarray:
    """(1 + 2 ``depth``, 6) uint32, dims 1 ... 1 + 2 ``depth``: the base,
    its permutation's first entry in ``sampler.arith_perms``' table
    (``ARITH_FIRST``), the digits evaluated, the tail's multiplier p**extra
    and added term mod 2**32 (1 and 0 without a tail) and the float32
    scale's bits, of ``sampler.arith_plan(base, index_bits)``."""
    rows = []
    for dim in range(1, 2 + 2 * depth):
        p = PRIMES[dim]
        perm, digits, extra, scale = sampler.arith_plan(p, index_bits)
        shift = (p ** extra) & 0xFFFFFFFF
        tail = (int(perm[0]) * ((p ** extra - 1) // (p - 1))) & 0xFFFFFFFF
        rows.append((p, ARITH_FIRST[p], digits, shift, tail,
                     int(np.float32(scale).view(np.uint32))))
    return np.array(rows, dtype=np.uint32).reshape(-1, PLAN_WORDS)


def wave_launcher(sampler, offsets, perm, depth: int, index_bits: int,
                  scale_x: float, scale_y: float, width: int, height: int):
    """Check a renderer's tables once and return ``launch(wave_offset, pos,
    cam)`` -> (ro, rd, sx_all, sy_all) of one wave: the lanes' Halton
    indices are ``offsets[perm[p]] + wave_offset`` (mod 2**32) over the
    block-ordered positions ``p`` (every one of ``perm``, or the int64
    tensor ``pos``); ``cam`` is the frame's (14,) float32 camera constants
    (``Renderer.frame_routes``).  ``offsets`` (the band's raster Halton
    offsets) and ``perm`` are int64."""
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"wave_inputs: depth {depth} draws dims past base "
                         f"{ARITH_MAX_PRIME}")
    _cuda.require_cuda("wave_inputs", offsets, perm)
    for what, t in (("offsets", offsets), ("perm", perm)):
        if t.dtype != torch.int64:
            raise ValueError(f"wave_inputs {what}: {t.dtype}, not int64")
    dev = offsets.device
    table = sampler.arith_perms(dev)
    plan = np.ascontiguousarray(dim_plan(sampler, depth, index_bits))
    fn = _cuda.lib().gi_wave_inputs_launch
    scales = (float(scale_x), float(scale_y),
              # a CUDA tensor divided by a Python number: times the float32
              # reciprocal (torch's div_true kernel)
              float(np.float32(1.0) / np.float32(width)),
              float(np.float32(1.0) / np.float32(height)))
    n_full = perm.shape[0]

    def launch(wave_offset: int, pos, cam):
        n = n_full if pos is None else pos.shape[0]
        _cuda.require_cuda("wave_inputs",
                           *((cam,) if pos is None else (cam, pos)))
        _cuda.require_shape("wave_inputs cam", cam, (14,))
        if cam.dtype != torch.float32 or (pos is not None
                                          and pos.dtype != torch.int64):
            raise ValueError(f"wave_inputs: cam {cam.dtype}, pos "
                             f"{None if pos is None else pos.dtype}")
        out = torch.empty(2 * depth * n + 3 * n, dtype=torch.float32,
                          device=dev)
        sx = out[:depth * n].view(depth, n)
        sy = out[depth * n:2 * depth * n].view(depth, n)
        rd = out[2 * depth * n:].view(n, 3)
        if n:
            code = fn(offsets.data_ptr(), perm.data_ptr(),
                      None if pos is None else pos.data_ptr(),
                      table.data_ptr(), table.shape[0], cam.data_ptr(), n,
                      depth, int(wave_offset) & 0xFFFFFFFF, *scales,
                      plan.ctypes.data, sx.data_ptr(), sy.data_ptr(),
                      rd.data_ptr(), _cuda.stream_ptr(dev))
            _cuda.check(code, "wave_inputs")
            _cuda.launches["wave_inputs"] += 1
        ro = torch.broadcast_to(cam[None, :3], (n, 3))
        return ro, rd, sx, sy

    return launch
