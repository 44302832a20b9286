"""Frozen copy of ``euler_xyz`` of
``gi_raytracer_tpu_torch/scene/build.py`` at commit
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0, which the mesh generators and
the scene builder share."""

from __future__ import annotations

import math

import numpy as np


def euler_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rotation matrix Rx(rx) @ Ry(ry) @ Rz(rz) (glm::eulerAngleXYZ)."""
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    rxm = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    rym = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rzm = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rxm @ rym @ rzm
