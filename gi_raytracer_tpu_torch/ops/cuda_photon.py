"""The photon pass's retry round in one launch: wrapper of the walk kernel's
photon-round policy (``csrc/photon.cu``).

One launch runs a whole retry round of one chunk: the emission, the
emission trace and the ``photon_depth`` chain steps (each K2's walk of the
chunk's live slots, tile for tile as the staged launch walks them), the
shading and the first diffuse hit's store, merged in place into the
chunk's arrays, whose stored count it adds to a device counter.  Its plain
version is the staged round of ``render/photon.py``, which the caller
takes wherever the kernel does not apply (``routes.photon_round``), so
this module has none of its own and raises on anything but CUDA tensors.

:func:`round_launcher` checks a chunk's inputs once and returns its
launch; :func:`round_info` reports the kernel's resources on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import routes
from . import _cuda
from . import cuda_intersect as ci
from .intersect import chunk_boxes, trace_tables
from .prim_rows import kernel_rows


def round_launcher(scene, light, keys, pos, dirs, col, stored, n_stored,
                   start: int, eps: float, shadow_bias: float,
                   halton: tuple):
    """Check a chunk's inputs once and return ``launch(rnd, salt0)``, which
    issues retry round ``rnd`` of the chunk whose slots are ``start`` on
    (``salt0``: its alpha-stream salt).  Each launch updates ``pos``,
    ``dirs``, ``col`` (n, 3) float32, ``stored`` (n,) bool and ``n_stored``
    (1,) int32, the chunk's stored count, in place.  ``light`` holds the
    light's 11 float32 constants (position, cone axis, radius, cone
    fraction, emitted colour); ``keys`` the threefry keys of every round,
    (rounds, 1 + depth, 2) uint32: round r's emission direction's, then
    each chain step's, at [r]; ``halton`` Halton dim 1's evaluation
    (``HaltonSampler.arith_plan(3)``)."""
    feat, accept = trace_tables(scene)
    cbox = chunk_boxes(scene)
    rows = kernel_rows(scene)
    n = pos.shape[0]
    _cuda.require_cuda("photon_round", feat, accept, cbox, rows, light, pos,
                       dirs, col, stored, n_stored)
    for what, t, shape, dt in (
            ("pos", pos, (n, 3), torch.float32),
            ("dir", dirs, (n, 3), torch.float32),
            ("col", col, (n, 3), torch.float32),
            ("stored", stored, (n,), torch.bool),
            ("stored count", n_stored, (1,), torch.int32),
            ("light", light, (11,), torch.float32)):
        _cuda.require_shape(f"photon_round {what}", t, shape)
        if t.dtype != dt:
            raise ValueError(f"photon_round {what}: {t.dtype}, not {dt}")
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    rounds, depth = keys.shape[0], keys.shape[1] - 1
    if (keys.shape != (rounds, depth + 1, 2)
            or not 0 <= depth <= routes.PHOTON_MAX_DEPTH):
        raise ValueError(f"photon_round: keys {keys.shape}, at most "
                         f"{routes.PHOTON_MAX_DEPTH} chain steps")
    if feat.shape[0] // ci.CHUNK_ROWS > ci.MAX_GROUPS:
        raise ValueError(f"photon_round: {feat.shape[0]} rows exceed the "
                         f"walk's {ci.MAX_GROUPS} chunks")
    perm, digits, extra, scale = halton
    if extra:
        raise ValueError(f"photon_round: Halton base 3 with {extra} digits "
                         f"past the index's")
    fn = _cuda.lib().gi_photon_round_launch
    head = (feat.data_ptr(), accept.data_ptr(), cbox.data_ptr(),
            feat.shape[0], int(bool(scene.all_opaque)), float(eps),
            rows.data_ptr(), light.data_ptr(), pos.data_ptr(),
            dirs.data_ptr(), col.data_ptr(), stored.data_ptr(),
            n_stored.data_ptr(), n, int(start), rounds)
    tail = (sum(int(p) << (2 * k) for k, p in enumerate(perm)), int(digits),
            float(scale), float(shadow_bias))
    stream = _cuda.stream_ptr(pos.device)
    kept = (feat, accept, cbox, rows, light, pos, dirs, col, stored,
            n_stored, keys)

    def launch(rnd: int, salt0: int):
        code = fn(*head, int(rnd), depth, int(salt0) & 0xFFFFFFFF, *tail,
                  kept[-1][rnd].ctypes.data, stream)
        _cuda.check(code, "photon_round (walk kernel, photon round)")
        _cuda.launches["photon_round"] += 1

    return launch


def round_info(scene) -> dict:
    """The round kernel's resources on the card for ``scene``'s table, as
    ``cuda_intersect.walk_info`` reports K2's."""
    out = (ctypes.c_int * 5)()
    t_pad = trace_tables(scene)[0].shape[0]
    _cuda.check(_cuda.lib().gi_photon_round_info(t_pad,
                                                 ctypes.addressof(out)),
                "photon_round info")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "dynamic_smem", "static_smem"), list(out)))
