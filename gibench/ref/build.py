"""Frozen copy of ``gi_raytracer_tpu_torch/scene/build.py`` at commit
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0, kept so that the benchmark
never imports the program for its reference or its scenes.

Host-side scene compiler: accumulates primitives and materials in numpy
and emits the flat torch ``Scene`` (+ BVH).

Counterpart of ``gi_raytracer_tpu.scene.build.SceneBuilder``: constant,
checker and image textures, triangles, analytic spheres and cones,
spherical lights and height fog.  The arithmetic is the JAX builder's, in
float64 numpy, cast once at the end, so both builders emit identical
arrays for identical calls (the fog's noise grid too: the same generator,
seed and shape).  The copy keeps no BVH, so its triangles stay in the
order they were added.  Triangles are kept in blocks, so
``add_triangles`` adds a whole mesh without a Python loop per triangle.

``build`` puts the scene on the card unless the caller passes
``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import types as T
from .euler import euler_xyz


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass
class _TexDef:
    kind: int
    color: tuple = (0.0, 0.0, 0.0)
    color2: tuple = (0.0, 0.0, 0.0)
    tiles: tuple = (1.0, 1.0)
    image: np.ndarray | None = None   # (H, W, 4) float RGBA, linear
    has_alpha: bool = False


class SceneBuilder:
    """Accumulates scene content, then compiles to a torch ``Scene``."""

    def __init__(self):
        # triangle blocks: (N, 3, 3) vertices and normals, (N, 3, 2) uvs,
        # (N,) material ids
        self._tri_v, self._tri_n, self._tri_uv, self._tri_mat = [], [], [], []
        self._sph_pos, self._sph_rad, self._sph_mat = [], [], []
        self._cone = []        # (pos, rot, rad, height, mat_id)
        self._light_pos, self._light_col, self._light_rad = [], [], []
        self._tex: list[_TexDef] = []
        self._mat = []         # (dif, em, rough, opac, ior)
        self._fog = None
        self._fog_seed = 0

    # --- content ----------------------------------------------------------
    def add_texture_const(self, color) -> int:
        self._tex.append(_TexDef(T.TEX_CONST, tuple(color)))
        return len(self._tex) - 1

    def add_texture_checker(self, tiles: int, a, b) -> int:
        self._tex.append(_TexDef(T.TEX_CHECKER, tuple(a), tuple(b),
                                 (float(tiles), float(tiles))))
        return len(self._tex) - 1

    def add_texture_image(self, image_rgba: np.ndarray, tiles=(1.0, 1.0),
                          has_alpha: bool = False) -> int:
        """image_rgba: (H, W, 4) float32 in linear space."""
        assert image_rgba.ndim == 3 and image_rgba.shape[2] == 4
        self._tex.append(_TexDef(T.TEX_IMAGE, tiles=tuple(tiles),
                                 image=image_rgba.astype(np.float32),
                                 has_alpha=has_alpha))
        return len(self._tex) - 1

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

    def add_sphere(self, pos, rad: float, mat_id: int):
        self._sph_pos.append(tuple(pos))
        self._sph_rad.append(float(rad))
        self._sph_mat.append(mat_id)

    def add_cone(self, pos, rot, rad: float, height: float, mat_id: int):
        """Analytic finite cone: base disk radius ``rad`` at local z=0,
        apex at z=``height``; ``rot`` = euler XYZ."""
        self._cone.append((tuple(pos), tuple(rot), float(rad), float(height),
                           int(mat_id)))

    def add_light(self, pos, col, rad: float):
        self._light_pos.append(tuple(pos))
        self._light_col.append(tuple(col))
        self._light_rad.append(float(rad))

    def add_height_fog(self, pos, size, col, density, scatter, noise_scale,
                       seed: int = 0):
        self._fog = (np.asarray(pos, np.float64), np.asarray(size, np.float64),
                     np.asarray(col, np.float64), float(density),
                     float(scatter), int(noise_scale))
        self._fog_seed = seed

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
        """Per-light photon-emission cone toward the specular geometry
        (specular triangles, then specular spheres; cones do not count):
        dir = mean specular bbox centre minus light; angle = max over
        specular prims of 1 - acos(dot(dir, light-to-bbox-min))/pi.

        The same values as the JAX builder's loop over every primitive: the
        specular filter, bounds and centres are exact elementwise ops and
        the mean reduces the same (N, 3) array; the angle is found with
        array ops, then recomputed with the JAX builder's scalar ops for
        the rows within 1e-9 of the maximum, so the maximum is its bits."""
        L = len(self._light_pos)
        dirs = np.zeros((L, 3))
        angles = np.zeros(L)
        mats = np.asarray(self._mat, np.float64) if self._mat else np.zeros((0, 5))
        rough = mats[:, 2] if len(mats) else np.zeros(0)

        sv = v[rough[tri_mat] < 0.1]
        sp = np.asarray(self._sph_pos, np.float64).reshape(-1, 3)
        sr = np.asarray(self._sph_rad, np.float64)
        sph_spec = rough[np.asarray(self._sph_mat, np.int64)] < 0.1
        sp, sr = sp[sph_spec], sr[sph_spec]
        if not len(sv) and not len(sp):
            return dirs, angles
        tri_mins = sv.min(1)
        spec_mins = np.concatenate([tri_mins, sp - sr[:, None]])
        spec_centers = np.concatenate([(tri_mins + (sv.max(1) + 1e-5)) / 2,
                                       sp])
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

    def build(self, dtype=torch.float32, device="cuda") -> T.Scene:
        """The torch ``Scene`` on ``device``, its triangles in the order
        they were added (no BVH: ``trace`` orders them itself)."""
        f = _NP_DTYPE[dtype]
        dev = torch.device(device)

        def t(x, np_dtype=f):
            return torch.from_numpy(np.array(x, np_dtype, order="C")).to(dev)

        v, n, uv, tri_mat = self._tris()
        Tn = v.shape[0]
        ldir, langle = self._light_cones(v, tri_mat)
        tri_min = v.min(1) if Tn else np.zeros((0, 3))
        tri_max = (v.max(1) + 1e-5) if Tn else np.zeros((0, 3))

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
        sp = np.asarray(self._sph_pos, np.float64).reshape(-1, 3)
        sr = np.asarray(self._sph_rad, np.float64)
        spheres = T.Spheres(pos=t(sp), rad=t(sr),
                            mat_id=t(self._sph_mat, np.int32))

        # analytic cones: world->local rotation is glm's row-vector
        # ``v * inverse(eulerAngleXYZ(r))``, which for an orthonormal euler
        # matrix M reduces to  local = M @ (world - pos)
        if self._cone:
            cpos = np.asarray([c[0] for c in self._cone], np.float64)
            crad = np.asarray([c[2] for c in self._cone], np.float64)
            chei = np.asarray([c[3] for c in self._cone], np.float64)
            cw2l = np.stack([euler_xyz(*c[1]) for c in self._cone])
            cones = T.Cones(pos=t(cpos), rad=t(crad), height=t(chei),
                            w2l=t(cw2l),
                            mat_id=t([c[4] for c in self._cone], np.int32))
            # bbox from the 5 transformed pyramid vertices
            base = np.array([[-1, -1, 0], [-1, 1, 0], [1, -1, 0], [1, 1, 0],
                             [0, 0, 0]], np.float64)
            verts = base[None] * crad[:, None, None]
            verts[:, 4, 2] = chei
            world = np.einsum("cji,cvj->cvi", cw2l, verts) + cpos[:, None]
            cone_min, cone_max = world.min(1), world.max(1)
        else:
            cones = None
            cone_min = cone_max = np.zeros((0, 3))

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

        textures = self._build_textures(t)

        pmin = np.concatenate([tri_min, sp - sr[:, None], cone_min], 0)
        pmax = np.concatenate([tri_max, sp + sr[:, None], cone_max], 0)
        wmin = pmin.min(0) if len(pmin) else np.zeros(3)
        wmax = pmax.max(0) if len(pmax) else np.ones(3)

        fog = None
        if self._fog is not None:
            pos, size, col, dens, scat, nscale = self._fog
            # one grid cell per world unit times the noise scale, drawn as
            # the JAX builder draws it, so both hold the same grid
            res = np.maximum(2, (size * max(1, nscale)).astype(int) + 1)
            grid = np.random.default_rng(self._fog_seed).random(tuple(res))
            fog = T.Fog(bbox_min=t(pos - 0.5 * size),
                        bbox_max=t(pos + 0.5 * size), color=t(col),
                        density=t(dens), scatter=t(scat), grid=t(grid))

        all_opaque = bool(np.all((mats[:, 3] >= 1.0) | (mats[:, 4] != 1.0)))
        has_img = any(x.kind == T.TEX_IMAGE for x in self._tex)
        return T.Scene(tris=tris, spheres=spheres, cones=cones, lights=lights,
                       materials=materials, textures=textures, bvh=None,
                       fog=fog, world_min=t(wmin), world_max=t(wmax),
                       all_opaque=all_opaque, has_image_tex=has_img)

    def _build_textures(self, t) -> T.Textures:
        """The texture table and the flat texel atlas (image k owns rows
        [offset[k], offset[k] + width[k]*height[k]))."""
        tex = self._tex or [_TexDef(T.TEX_CONST, (1.0, 0.0, 0.0))]
        K = len(tex)
        offset = np.zeros(K, np.int32)
        width = np.ones(K, np.int32)
        height = np.ones(K, np.int32)
        has_alpha = np.zeros(K, bool)
        atlas_parts = []
        cursor = 0
        for i, x in enumerate(tex):
            if x.kind == T.TEX_IMAGE:
                h, w = x.image.shape[:2]
                offset[i] = cursor
                width[i], height[i] = w, h
                has_alpha[i] = x.has_alpha
                atlas_parts.append(x.image.reshape(-1, 4))
                cursor += w * h
        atlas = (np.concatenate(atlas_parts, 0) if atlas_parts
                 else np.ones((1, 4), np.float32))
        return T.Textures(
            kind=t([x.kind for x in tex], np.int32),
            color=t(np.asarray([x.color for x in tex], np.float64)),
            color2=t(np.asarray([x.color2 for x in tex], np.float64)),
            tiles=t(np.asarray([x.tiles for x in tex], np.float64)),
            offset=t(offset, np.int32), width=t(width, np.int32),
            height=t(height, np.int32), has_alpha=t(has_alpha, np.bool_),
            atlas=t(atlas))
