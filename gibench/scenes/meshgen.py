"""Frozen copy of ``gi_raytracer_tpu_torch/scene/meshgen.py`` at commit
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0, kept so that the benchmark
never imports the program for its reference or its scenes.

Procedural mesh generators -> triangle arrays.

Reimplementation of the reference's mesh-emitting pseudo-entities
(entities.h:562-785): octahedron-subdivision sphere, cone fan, quad and box.
These are host-side helpers that return vertex arrays for SceneBuilder.
"""

from __future__ import annotations

import math

import numpy as np

from ..ref.euler import euler_xyz


def sphere_mesh(pos, rad: float, subdivs: int):
    """Octahedron subdivided ``subdivs`` times, vertices normalized onto the
    sphere (entities.h:562-631).  Returns (verts (N,3,3), normals, uvs)."""
    z = np.array
    base = [
        (z([-1., 0, 0]), z([0., -1, 0]), z([0., 0, -1])),
        (z([0., -1, 0]), z([1., 0, 0]), z([0., 0, -1])),
        (z([1., 0, 0]), z([0., 1, 0]), z([0., 0, -1])),
        (z([0., 1, 0]), z([-1., 0, 0]), z([0., 0, -1])),
        (z([-1., 0, 0]), z([0., -1, 0]), z([0., 0, 1])),
        (z([0., -1, 0]), z([1., 0, 0]), z([0., 0, 1])),
        (z([1., 0, 0]), z([0., 1, 0]), z([0., 0, 1])),
        (z([0., 1, 0]), z([-1., 0, 0]), z([0., 0, 1])),
    ]
    tris = np.stack([np.stack(t) for t in base])  # (8,3,3)

    def norm(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    for _ in range(subdivs):
        v1, v2, v3 = norm(tris[:, 0]), norm(tris[:, 1]), norm(tris[:, 2])
        a = norm((v1 + v2) / 2)
        b = norm((v2 + v3) / 2)
        c = norm((v1 + v3) / 2)
        tris = np.concatenate([
            np.stack([v1, a, c], 1), np.stack([a, v2, b], 1),
            np.stack([a, b, c], 1), np.stack([c, b, v3], 1)], 0)

    unit = norm(tris)
    verts = rad * unit + np.asarray(pos, np.float64)
    normals = unit
    # spherical UVs as in entities.h:623-625 (atan has a seam; kept for parity)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = 0.5 * np.arccos(np.clip(unit[..., 1], -1, 1)) / math.pi + 0.5
        vv = 0.5 * np.arctan(np.where(unit[..., 0] != 0,
                                      unit[..., 2] / unit[..., 0], 0.0)) / (2 * math.pi) + 0.5
    uvs = np.stack([u, vv], -1)
    return verts, normals, uvs


def cone_mesh(pos, rot, rad: float, height: float, n_tris: int):
    """Cone as a fan of side + base triangles (entities.h:644-675)."""
    R = euler_xyz(*rot)
    pos = np.asarray(pos, np.float64)
    step = euler_xyz(0.0, 0.0, 2 * math.pi / n_tris)
    last = np.array([rad, 0.0, 0.0])
    verts, normals = [], []
    top = np.array([0.0, 0.0, height])
    down = R @ np.array([0.0, 0.0, -1.0])
    for _ in range(n_tris):
        nxt = step @ last
        side_n = R @ last  # reference uses the slant vertex as normal
        verts.append([R @ last + pos, R @ nxt + pos, R @ top + pos])
        normals.append([side_n, R @ nxt, side_n])
        verts.append([R @ last + pos, R @ nxt + pos, pos])
        normals.append([down, down, down])
        last = nxt
    verts = np.asarray(verts)
    normals = np.asarray(normals)
    normals = normals / np.maximum(
        np.linalg.norm(normals, axis=-1, keepdims=True), 1e-300)
    return verts, normals, np.zeros((len(verts), 3, 2))


def quad_mesh(v1, v2, v3, v4):
    """Two triangles (v1,v2,v3), (v3,v2,v4) (entities.h:721-727)."""
    v1, v2, v3, v4 = (np.asarray(v, np.float64) for v in (v1, v2, v3, v4))
    return np.stack([np.stack([v1, v2, v3]), np.stack([v3, v2, v4])])


def box_mesh(pos, size, rot):
    """12 triangles; the reference normalizes each unit corner before scaling,
    so the half-extent is size/sqrt(3) (entities.h:770-773) — kept for parity."""
    c = [
        [(-1, -1, -1), (-1, 1, -1), (1, -1, -1)],
        [(-1, 1, -1), (1, 1, -1), (1, -1, -1)],
        [(-1, -1, -1), (-1, -1, 1), (-1, 1, -1)],
        [(-1, -1, 1), (-1, 1, 1), (-1, 1, -1)],
        [(-1, -1, -1), (1, -1, -1), (-1, -1, 1)],
        [(-1, -1, 1), (1, -1, -1), (1, -1, 1)],
        [(-1, -1, 1), (1, -1, 1), (-1, 1, 1)],
        [(1, -1, 1), (1, 1, 1), (-1, 1, 1)],
        [(-1, 1, 1), (1, 1, 1), (1, 1, -1)],
        [(-1, 1, 1), (1, 1, -1), (-1, 1, -1)],
        [(1, -1, -1), (1, 1, -1), (1, -1, 1)],
        [(1, -1, 1), (1, 1, -1), (1, 1, 1)],
    ]
    tris = np.asarray(c, np.float64)                     # (12,3,3)
    tris = tris / np.linalg.norm(tris, axis=-1, keepdims=True)
    tris = tris * np.asarray(size, np.float64)
    R = euler_xyz(*rot)
    tris = tris @ R.T + np.asarray(pos, np.float64)
    return tris
