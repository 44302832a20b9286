"""Frozen copy of ``gi_raytracer_tpu_torch/scene/cornell.py`` at commit
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0, kept so that the benchmark
never imports the program for its reference or its scenes.

The Cornell box the port renders, built in code.

Five +-4 walls, a diffuse box, a glass sphere and a mirror sphere, all as
triangle meshes, so the scene is megakernel-eligible; one spherical area
light under the ceiling.  The full box has 10 + 12 + 2,048 + 128 = 2,198
triangles (18 chunks of 128); ``full=False`` is the test-size variant with
10 + 12 + 128 + 32 = 182 triangles (2 chunks).  ``glass_subdivs`` sets the
glass sphere's subdivision level (8 * 4^s triangles): at 7 it has 131,072
triangles and the box 131,222 (``GLASS_TRIS``), the high-poly glass scene
that takes the big-scene path (the staged wave on the superchunk trace).

``analytic=True`` keeps the walls, the box and the light, makes the glass
and mirror spheres analytic (``add_sphere`` at the mesh spheres' centres
and radii), stands one diffuse analytic cone on the floor and gives the
floor an image texture: a 256x256 RGBA array drawn from ``seed`` with
numpy (8x8 tiles of random colour).  That box has 22 triangles, 2 spheres
and 1 cone (``ANALYTIC_TRIS``); it takes the staged wave (K2 and the
analytic passes), not the megakernel.

``cornell_box`` takes the builder class and the mesh module as arguments,
so the JAX package's ``SceneBuilder``/``meshgen`` can build the identical
scene for the parity tests without this package importing JAX.  It returns
the populated builder; call ``.build(...)`` on it.

The camera at (0, 0, -14) looking at the origin sees world +x on the left
of the image, so the red wall sits at x = +4 (image left) and the blue
wall at x = -4 (image right).
"""

from __future__ import annotations

import math

import numpy as np

CAMERA_POS = (0.0, 0.0, -14.0)
CAMERA_LOOK_AT = (0.0, 0.0, 0.0)

FULL_TRIS = 2198
SMALL_TRIS = 182
GLASS_SUBDIVS = 7
GLASS_TRIS = 131_222
ANALYTIC_TRIS = 22
FLOOR_TEX = 256


def floor_image(seed: int = 0, size: int = FLOOR_TEX) -> np.ndarray:
    """(size, size, 4) float32 linear RGBA: 8x8 tiles of random colour in
    [0.15, 0.9] from ``seed``, alpha 1."""
    rng = np.random.default_rng(seed)
    tiles = rng.uniform(0.15, 0.9, (8, 8, 3))
    rgb = np.repeat(np.repeat(tiles, size // 8, 0), size // 8, 1)
    return np.concatenate([rgb, np.ones((size, size, 1))], -1).astype(
        np.float32)


def cornell_box(builder, meshgen, full: bool = True,
                glass_subdivs: int | None = None, analytic: bool = False,
                seed: int = 0):
    """Populate a ``builder()`` with the Cornell box; returns the builder."""
    b = builder()
    white = b.add_texture_const((0.9, 0.9, 0.9))
    red = b.add_texture_const((0.8, 0.2, 0.2))
    blue = b.add_texture_const((0.2, 0.2, 0.8))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    m_white = b.add_material(white, black, 1.0, 1.0, 1.0)
    m_red = b.add_material(red, black, 1.0, 1.0, 1.0)
    m_blue = b.add_material(blue, black, 1.0, 1.0, 1.0)
    m_glass = b.add_material(white, black, 0.0, 0.0, 1.5)
    m_mirror = b.add_material(white, black, 0.0, 1.0, 1.0)

    s = 4.0
    quad = meshgen.quad_mesh
    # floor, ceiling, back wall
    floor = quad((-s, -s, -s), (s, -s, -s), (-s, -s, s), (s, -s, s))
    if analytic:
        # the image needs uvs, and uvs count only with vertex normals
        img = b.add_texture_image(floor_image(seed), (2.0, 2.0))
        m_floor = b.add_material(img, black, 1.0, 1.0, 1.0)
        uv = (floor[..., [0, 2]] + s) / (2 * s)
        up = np.broadcast_to(np.array([0.0, 1.0, 0.0]), floor.shape)
        b.add_triangles(floor, up, uv, mat_id=m_floor)
    else:
        b.add_triangles(floor, mat_id=m_white)
    b.add_triangles(quad((-s, s, -s), (s, s, -s), (-s, s, s), (s, s, s)),
                    mat_id=m_white)
    b.add_triangles(quad((-s, -s, s), (s, -s, s), (-s, s, s), (s, s, s)),
                    mat_id=m_white)
    # red wall at x = +s (image left), blue wall at x = -s (image right)
    b.add_triangles(quad((s, -s, s), (s, -s, -s), (s, s, s), (s, s, -s)),
                    mat_id=m_red)
    b.add_triangles(quad((-s, -s, -s), (-s, -s, s), (-s, s, -s), (-s, s, s)),
                    mat_id=m_blue)

    # diffuse box (box_mesh half-extent is size / sqrt(3) = 0.98), sunk
    # 0.03 into the floor so no thin gap separates the two
    b.add_triangles(meshgen.box_mesh((1.9, -3.05, 1.6), 1.7, (0.0, 0.4, 0.0)),
                    mat_id=m_white)
    # glass sphere sunk 0.05 into the floor, mirror sphere 0.05 above the box
    if analytic:
        b.add_sphere((-1.4, -2.85, -0.6), 1.2, m_glass)
        b.add_sphere((1.9, -1.12, 1.6), 0.9, m_mirror)
        # in front of the box, apex up: the x rotation by pi/2 takes
        # world +y to local +z
        m_cone = b.add_material(b.add_texture_const((0.85, 0.65, 0.2)),
                                black, 1.0, 1.0, 1.0)
        b.add_cone((2.2, -s, -1.8), (math.pi / 2, 0.0, 0.0), 0.8, 2.0,
                   m_cone)
        b.add_light((0.0, 3.0, 0.0), (8.0, 8.0, 8.0), 0.3)
        return b
    if glass_subdivs is None:
        glass_subdivs = 4 if full else 2
    gv, gn, guv = meshgen.sphere_mesh((-1.4, -2.85, -0.6), 1.2,
                                      glass_subdivs)
    b.add_triangles(gv, gn, guv, mat_id=m_glass)
    mv, mn, muv = meshgen.sphere_mesh((1.9, -1.12, 1.6), 0.9,
                                      2 if full else 1)
    b.add_triangles(mv, mn, muv, mat_id=m_mirror)

    b.add_light((0.0, 3.0, 0.0), (8.0, 8.0, 8.0), 0.3)
    return b
