"""Host-side scene compiler: accumulates primitives and materials in numpy
and emits the flat torch ``Scene`` (+ BVH).

Counterpart of ``gi_raytracer_tpu.scene.build.SceneBuilder`` for the
triangle-only scenes the port renders: constant and checker textures,
triangles, spherical lights.  The arithmetic is the JAX builder's, in
float64 numpy, cast once at the end, so both builders emit identical
arrays for identical calls; the BVH (and so the triangle order) is the
native binned-SAH tree, as in the JAX package.  Triangles are kept in
blocks, so ``add_triangles`` adds a whole mesh without a Python loop per
triangle.  Analytic spheres, cones and fog have no builder method yet
(``meshgen`` makes sphere and cone meshes), and image textures raise
``NotImplementedError``, until the port carries them.

``build`` puts the scene on the card unless the caller passes
``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops._cuda import resolve_device
from . import types as T
from .bvh import build_bvh


def euler_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    """Rotation matrix Rx(rx) @ Ry(ry) @ Rz(rz) (glm::eulerAngleXYZ)."""
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    rxm = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    rym = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rzm = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rxm @ rym @ rzm


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


class SceneBuilder:
    """Accumulates scene content, then compiles to a torch ``Scene``."""

    def __init__(self):
        # triangle blocks: (N, 3, 3) vertices and normals, (N, 3, 2) uvs,
        # (N,) material ids
        self._tri_v, self._tri_n, self._tri_uv, self._tri_mat = [], [], [], []
        self._light_pos, self._light_col, self._light_rad = [], [], []
        self._tex = []         # (kind, color, color2, tiles)
        self._mat = []         # (dif, em, rough, opac, ior)

    # --- content ----------------------------------------------------------
    def add_texture_const(self, color) -> int:
        self._tex.append((T.TEX_CONST, tuple(color), (0.0, 0.0, 0.0),
                          (1.0, 1.0)))
        return len(self._tex) - 1

    def add_texture_checker(self, tiles: int, a, b) -> int:
        self._tex.append((T.TEX_CHECKER, tuple(a), tuple(b),
                          (float(tiles), float(tiles))))
        return len(self._tex) - 1

    def add_texture_image(self, *args, **kw) -> int:
        raise NotImplementedError("image textures are not ported yet")

    def add_material(self, diffuse_tex: int, emissive_tex: int,
                     roughness: float, opacity: float, ior: float = 1.0) -> int:
        self._mat.append((diffuse_tex, emissive_tex, roughness, opacity, ior))
        return len(self._mat) - 1

    def add_triangle(self, verts, normals=None, uvs=None, mat_id: int = 0):
        self.add_triangles(np.asarray(verts, np.float64).reshape(1, 3, 3),
                           None if normals is None
                           else np.asarray(normals).reshape(1, 3, 3),
                           None if uvs is None
                           else np.asarray(uvs).reshape(1, 3, 2), mat_id)

    def add_triangles(self, verts, normals=None, uvs=None, mat_id: int = 0):
        """Bulk add: verts (N,3,3), normals (N,3,3) or None, uvs (N,3,2).
        Nonzero vertex normals are normalised, as ``add_triangle`` does
        one triangle at a time in the JAX builder (the same float64 ops,
        so the same bits)."""
        v = np.asarray(verts, np.float64).reshape(-1, 3, 3)
        N = v.shape[0]
        n = (np.zeros((N, 3, 3)) if normals is None
             else np.asarray(normals, np.float64).reshape(N, 3, 3))
        ln = np.linalg.norm(n, axis=2, keepdims=True)
        n = np.where(ln > 0, n / np.maximum(ln, 1e-300), 0.0)
        uv = (np.zeros((N, 3, 2)) if uvs is None
              else np.asarray(uvs, np.float64).reshape(N, 3, 2))
        self._tri_v.append(v)
        self._tri_n.append(n)
        self._tri_uv.append(uv)
        self._tri_mat.append(np.full(N, int(mat_id), np.int32))

    def add_light(self, pos, col, rad: float):
        self._light_pos.append(tuple(pos))
        self._light_col.append(tuple(col))
        self._light_rad.append(float(rad))

    # --- compile ------------------------------------------------------------
    def _tris(self):
        """All triangles so far: (T,3,3) vertices, normals, (T,3,2) uvs,
        (T,) int32 material ids."""
        if not self._tri_v:
            return (np.zeros((0, 3, 3)), np.zeros((0, 3, 3)),
                    np.zeros((0, 3, 2)), np.zeros(0, np.int32))
        return (np.concatenate(self._tri_v), np.concatenate(self._tri_n),
                np.concatenate(self._tri_uv), np.concatenate(self._tri_mat))

    def _light_cones(self, v, tri_mat):
        """Per-light photon-emission cone toward the specular geometry:
        dir = mean specular bbox centre minus light; angle = max over
        specular prims of 1 - acos(dot(dir, light-to-bbox-min))/pi.

        The same values as the JAX builder's loop over every triangle: the
        specular filter, bounds and centres are exact elementwise ops and
        the mean reduces the same (N, 3) array; the angle is found with
        array ops, then recomputed with the JAX builder's scalar ops for
        the rows within 1e-9 of the maximum, so the maximum is its bits."""
        L = len(self._light_pos)
        dirs = np.zeros((L, 3))
        angles = np.zeros(L)
        mats = np.asarray(self._mat, np.float64) if self._mat else np.zeros((0, 5))
        rough = mats[:, 2] if len(mats) else np.zeros(0)

        spec = rough[tri_mat] < 0.1
        if not spec.any():
            return dirs, angles
        sv = v[spec]
        spec_mins = sv.min(1)
        spec_centers = (spec_mins + (sv.max(1) + 1e-5)) / 2
        avg = np.mean(spec_centers, 0)
        for i, lp in enumerate(self._light_pos):
            lp = np.asarray(lp)
            d = avg - lp
            d /= np.linalg.norm(d)
            dirs[i] = d
            ws = lp - spec_mins
            ws = ws / np.linalg.norm(ws, axis=1, keepdims=True)
            approx = 1.0 - np.arccos(np.clip(ws @ d, -1, 1)) / math.pi
            best = 0.0
            for bmin in spec_mins[approx >= approx.max() - 1e-9]:
                w = lp - bmin
                w = w / np.linalg.norm(w)
                a = 1.0 - math.acos(np.clip(np.dot(d, w), -1, 1)) / math.pi
                best = max(best, a)
            angles[i] = best
        return dirs, angles

    def build(self, dtype=torch.float32, device="cuda",
              leaf_size: int = 4, use_native: bool = True) -> T.Scene:
        """The torch ``Scene`` on ``device`` (the card by default).
        ``use_native=False`` orders the triangles by the numpy median-split
        BVH instead of the native SAH tree."""
        f = _NP_DTYPE[dtype]
        dev = resolve_device(device)

        def t(x, np_dtype=f):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(x, np_dtype))).to(dev)

        v, n, uv, tri_mat = self._tris()
        Tn = v.shape[0]
        ldir, langle = self._light_cones(v, tri_mat)
        # BVH first, so the triangle arrays can be permuted into leaf order
        # (consecutive triangles spatially coherent)
        tri_min = v.min(1) if Tn else np.zeros((0, 3))
        tri_max = (v.max(1) + 1e-5) if Tn else np.zeros((0, 3))
        bvh_np = build_bvh(tri_min, tri_max, leaf_size=leaf_size,
                           use_native=use_native)
        perm = (np.asarray(bvh_np.prim_idx, np.int64) if Tn
                else np.zeros(0, np.int64))
        v, n, uv = v[perm], n[perm], uv[perm]
        tri_min, tri_max = tri_min[perm], tri_max[perm]
        tri_mat = tri_mat[perm]

        e1 = v[:, 1] - v[:, 0]
        e2 = v[:, 2] - v[:, 0]
        fn = np.cross(e1, e2)
        ln = np.linalg.norm(fn, axis=1, keepdims=True)
        fn = fn / np.maximum(ln, 1e-300)

        tris = T.Triangles(
            v0=t(v[:, 0]), e1=t(e1), e2=t(e2),
            n0=t(n[:, 0]), n1=t(n[:, 1]), n2=t(n[:, 2]),
            uv0=t(uv[:, 0]), uv1=t(uv[:, 1]), uv2=t(uv[:, 2]),
            face_n=t(fn), mat_id=t(tri_mat, np.int32))
        spheres = T.Spheres(pos=t(np.zeros((0, 3))), rad=t(np.zeros(0)),
                            mat_id=t(np.zeros(0), np.int32))

        lights = T.Lights(
            pos=t(np.asarray(self._light_pos, np.float64).reshape(-1, 3)),
            col=t(np.asarray(self._light_col, np.float64).reshape(-1, 3)),
            rad=t(np.asarray(self._light_rad, np.float64)),
            dir=t(ldir), angle=t(langle))

        mats = (np.asarray(self._mat, np.float64) if self._mat
                else np.zeros((1, 5)) + [[0, 0, 0.75, 1, 1]])
        materials = T.Materials(
            diffuse_tex=t(mats[:, 0], np.int32),
            emissive_tex=t(mats[:, 1], np.int32),
            roughness=t(mats[:, 2]), opacity=t(mats[:, 3]), ior=t(mats[:, 4]))

        tex = self._tex or [(T.TEX_CONST, (1.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                             (1.0, 1.0))]
        K = len(tex)
        textures = T.Textures(
            kind=t([x[0] for x in tex], np.int32),
            color=t(np.asarray([x[1] for x in tex], np.float64)),
            color2=t(np.asarray([x[2] for x in tex], np.float64)),
            tiles=t(np.asarray([x[3] for x in tex], np.float64)),
            offset=t(np.zeros(K), np.int32), width=t(np.ones(K), np.int32),
            height=t(np.ones(K), np.int32),
            has_alpha=t(np.zeros(K), np.bool_),
            atlas=t(np.ones((1, 4))))

        bvh = T.BVH(node_min=t(bvh_np.node_min), node_max=t(bvh_np.node_max),
                    skip=t(bvh_np.skip, np.int32),
                    first=t(bvh_np.first, np.int32),
                    count=t(bvh_np.count, np.int32),
                    prim_idx=t(np.arange(Tn), np.int32),
                    leaf_size=leaf_size)

        wmin = tri_min.min(0) if Tn else np.zeros(3)
        wmax = tri_max.max(0) if Tn else np.ones(3)
        all_opaque = bool(np.all((mats[:, 3] >= 1.0) | (mats[:, 4] != 1.0)))
        return T.Scene(tris=tris, spheres=spheres, cones=None, lights=lights,
                       materials=materials, textures=textures, bvh=bvh,
                       fog=None, world_min=t(wmin), world_max=t(wmax),
                       all_opaque=all_opaque, has_image_tex=False)
