"""Frozen copy of ``gi_raytracer_tpu_torch/scene/terrain.py`` at commit
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0, kept so that the benchmark
never imports the program for its reference or its scenes.

The big-scene workload: a wavy terrain mesh.

The port's copy of ``scripts/bench_big_scenes.terrain_scene``: an n x n
height field y = 1.5 sin(0.7 x) cos(0.6 z) over [-20, 20]^2, two triangles
per grid cell ((n-1)^2 * 2 in all: 999,698 at n = 708), one opaque white
material and one light.  Like ``cornell.cornell_box`` it takes the
builder class, so the JAX package's ``SceneBuilder`` builds the identical
scene for the parity tests, and returns the populated builder.
"""

from __future__ import annotations

import numpy as np

CAMERA_POS = (0.0, 18.0, -30.0)
CAMERA_LOOK_AT = (0.0, 0.0, 0.0)
# scripts/bench_big_scenes.py's sizes: 250,632, 500,000, 999,698 triangles
SIZES = (355, 501, 708)
BIG_N = SIZES[-1]


def terrain_tris(n: int) -> int:
    return (n - 1) * (n - 1) * 2


def terrain_scene(builder, n: int):
    """Populate a ``builder()`` with the (n-1)^2 * 2-triangle terrain and
    its light; returns the builder."""
    b = builder()
    white = b.add_texture_const((0.8, 0.8, 0.8))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    m = b.add_material(white, black, 1.0, 1.0, 1.0)
    xs = np.linspace(-20, 20, n)
    zs = np.linspace(-20, 20, n)
    X, Z = np.meshgrid(xs, zs)
    Y = 1.5 * np.sin(X * 0.7) * np.cos(Z * 0.6)
    P = np.stack([X, Y, Z], -1)                      # (n, n, 3)
    a, bb, c, d = P[:-1, :-1], P[:-1, 1:], P[1:, :-1], P[1:, 1:]
    t1 = np.stack([a, bb, c], 2).reshape(-1, 3, 3)
    t2 = np.stack([bb, d, c], 2).reshape(-1, 3, 3)
    b.add_triangles(np.concatenate([t1, t2], 0), mat_id=m)
    b.add_light((0.0, 25.0, 0.0), (600.0, 600.0, 600.0), 1.0)
    return b
