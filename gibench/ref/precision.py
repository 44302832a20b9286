"""The reference's precision switch, for the control of ``correct``.

The configurations state float32.  The control is the reference computed
one step lower, in bfloat16: with ``bfloat16()`` in force, ``lower``
rounds every float tensor it is given through bfloat16, and the wave,
the photon pass and the trace apply it to the state they carry from one
stage to the next (ray origins and directions, throughput, radiance,
photon positions and colours).  Outside the switch it returns its
argument.
"""

from __future__ import annotations

import contextlib

import torch

_LOWER = [False]


def lower(x: torch.Tensor) -> torch.Tensor:
    if _LOWER[0] and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


@contextlib.contextmanager
def bfloat16():
    """Round the reference's carried state through bfloat16 inside."""
    _LOWER[0] = True
    try:
        yield
    finally:
        _LOWER[0] = False
