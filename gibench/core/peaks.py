"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
limit), as ``chip_smoke.py`` at commit
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0 holds them, and the roofline
bound from them."""

from __future__ import annotations

PEAK_FP32 = 67e12          # FP32 operations per second outside tensor cores
PEAK_BYTES = 3.35e12       # device memory bytes per second
# FP32 arithmetic of one ray-triangle test (Moller-Trumbore: m 5, |det| 1,
# u 11, v 11, t 6, signs 3, u+v 1, max 1, reciprocal 1, product 1) and of
# one kNN candidate's d^2 (3 sub, 3 mul, 2 add)
OPS_PER_TEST = 41
OPS_PER_CANDIDATE = 8


def bound(ops: float, nbytes: float) -> tuple:
    """(seconds, "operations" | "bytes"): the least time the card could
    take for ``ops`` FP32 operations that move ``nbytes`` bytes."""
    t_ops = ops / PEAK_FP32
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
