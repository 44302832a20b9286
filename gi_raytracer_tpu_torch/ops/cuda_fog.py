"""The fog march in one launch: wrapper of ``csrc/fog.cu``.

One thread a lane walks the lane's steps to its first scattering step, or
to its first step past ``tmax``, bit-equal to the step loop
(``render.atmosphere._march_steps``) and the blocked march
(``atmosphere._march``), which is its plain version: the caller takes the
kernel where ``routes.fog_march`` names it and ``_march`` everywhere else,
so this module has no plain version of its own and raises on anything but
CUDA tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda

MAX_GRID_BYTES = 227 * 1024   # the shared memory a block of sm_90 may take
NOISE_POW = 7.0               # fog_density's noise ** 7

_scratch: dict = {}           # device -> the launches' four uint64 counts


def _rows(name, t):
    """``t`` (R, 3) float32 with unit column stride (a row stride of 0, a
    broadcast origin, is kept), and its row stride."""
    _cuda.require_shape(f"fog_march {name}", t, (t.shape[0], 3))
    if t.stride(1) != 1 or t.stride(0) < 0:
        t = t.contiguous()
    return t, t.stride(0)


def march(fog, ro, rd, t0, tmax, has, ray_id, salt: int, step: float,
          max_steps: int, block_steps: int, counts=None):
    """(found (R,) bool, the scattering step (R,) int32, 0 where none) of
    every lane: the march from ``t0`` (tmin + shadow bias) in steps of
    ``step`` while t < ``tmax``, over lanes where ``has`` and ``t0 <
    tmax``; the scatter draws keyed by ``ray_id`` (int64, its low 32 bits;
    None: the lane index) and ``salt``.  ``counts``: None, or the address
    of three int64 the launch adds its lanes, lane-steps and blocks of
    ``block_steps`` steps to (``telemetry.counts_ptr``)."""
    ro, ro_stride = _rows("ro", ro)
    rd, rd_stride = _rows("rd", rd)
    n = ro.shape[0]
    kept = [t0, tmax, has, fog.bbox_min, fog.bbox_max, fog.density,
            fog.grid]
    if ray_id is not None:
        ray_id = ray_id if ray_id.dtype == torch.int64 else ray_id.long()
        kept.append(ray_id)
    _cuda.require_cuda("fog_march", *kept)
    if ro.device != t0.device or rd.device != t0.device:
        raise ValueError(f"fog_march: rays on {ro.device} and {rd.device}, "
                         f"the march on {t0.device}")
    if fog.grid.dim() != 3:
        raise ValueError(f"fog_march grid: {tuple(fog.grid.shape)}, not 3-D")
    nx, ny, nz = fog.grid.shape
    for what, t, shape, dt in (
            ("ro", ro, (n, 3), torch.float32), ("rd", rd, (n, 3), torch.float32),
            ("t0", t0, (n,), torch.float32), ("tmax", tmax, (n,), torch.float32),
            ("has", has, (n,), torch.bool),
            ("bbox_min", fog.bbox_min, (3,), torch.float32),
            ("bbox_max", fog.bbox_max, (3,), torch.float32),
            ("density", fog.density, (), torch.float32),
            ("grid", fog.grid, (nx, ny, nz), torch.float32)) + (
            () if ray_id is None else (("ray_id", ray_id, (n,), torch.int64),)):
        _cuda.require_shape(f"fog_march {what}", t, shape)
        if t.dtype != dt:
            raise ValueError(f"fog_march {what}: {t.dtype}, not {dt}")
    if 4 * nx * ny * nz > MAX_GRID_BYTES:
        raise ValueError(f"fog_march: a {nx}x{ny}x{nz} grid passes "
                         f"{MAX_GRID_BYTES} bytes of shared memory")
    dev = ro.device
    found = torch.empty(n, dtype=torch.bool, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    if not n:
        return found, idx
    scratch = _scratch.get(dev)
    if scratch is None:
        scratch = _scratch[dev] = torch.zeros(4, dtype=torch.int64,
                                              device=dev)
    tops = (float(np.float32(m - 1.001)) for m in (nx, ny, nz))
    code = _cuda.lib().gi_fog_march_launch(
        ro.data_ptr(), ro_stride, rd.data_ptr(), rd_stride, t0.data_ptr(),
        tmax.data_ptr(), has.data_ptr(),
        None if ray_id is None else ray_id.data_ptr(), n,
        int(salt) & 0xFFFFFFFF, fog.bbox_min.data_ptr(),
        fog.bbox_max.data_ptr(), fog.density.data_ptr(), fog.grid.data_ptr(),
        nx, ny, nz, *tops, NOISE_POW, float(step), int(max_steps),
        int(block_steps), found.data_ptr(), idx.data_ptr(),
        scratch.data_ptr(), counts, _cuda.stream_ptr(dev))
    _cuda.check(code, "fog_march")
    _cuda.launches["fog_march"] += 1
    return found, idx


def march_info(grid_shape) -> dict:
    """The kernel's resources on the card for a grid of ``grid_shape``."""
    out = (ctypes.c_int * 5)()
    _cuda.check(_cuda.lib().gi_fog_march_info(int(np.prod(grid_shape)),
                                              ctypes.addressof(out)),
                "fog_march info")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "dynamic_smem", "threads"), list(out)))
