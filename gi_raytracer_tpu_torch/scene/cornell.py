"""The Cornell box the port renders, built in code (triangle-only).

Five +-4 walls, a diffuse box, a glass sphere and a mirror sphere, all as
triangle meshes, so the scene is megakernel-eligible; one spherical area
light under the ceiling.  The full box has 10 + 12 + 2,048 + 128 = 2,198
triangles (18 chunks of 128); ``full=False`` is the test-size variant with
10 + 12 + 128 + 32 = 182 triangles (2 chunks).  ``glass_subdivs`` sets the
glass sphere's subdivision level (8 * 4^s triangles): at 7 it has 131,072
triangles and the box 131,222 (``GLASS_TRIS``), the high-poly glass scene
that takes the big-scene path (the staged wave on the superchunk trace).

``cornell_box`` takes the builder class and the mesh module as arguments,
so the JAX package's ``SceneBuilder``/``meshgen`` can build the identical
scene for the parity tests without this package importing JAX.  It returns
the populated builder; call ``.build(...)`` on it.

The camera at (0, 0, -14) looking at the origin sees world +x on the left
of the image, so the red wall sits at x = +4 (image left) and the blue
wall at x = -4 (image right).
"""

from __future__ import annotations

CAMERA_POS = (0.0, 0.0, -14.0)
CAMERA_LOOK_AT = (0.0, 0.0, 0.0)

FULL_TRIS = 2198
SMALL_TRIS = 182
GLASS_SUBDIVS = 7
GLASS_TRIS = 131_222


def cornell_box(builder, meshgen, full: bool = True,
                glass_subdivs: int | None = None):
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
    b.add_triangles(quad((-s, -s, -s), (s, -s, -s), (-s, -s, s), (s, -s, s)),
                    mat_id=m_white)
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
