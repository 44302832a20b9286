"""OBJ mesh reader -> numpy triangle arrays.

Counterpart of ``gi_raytracer_tpu.scene.objio``: the reference loader's
subset (``v``, ``vt``, ``vn``, fan-triangulated ``f v/t/n`` faces,
meshLoader.cpp:54-93) plus the ``f v//n`` and ``f v`` variants and
negative (relative) indices.  Rotation (euler XYZ) and translation are
baked into vertices and normals at load, as meshLoader.cpp:58,74 does.
The native parser (``gi_raytracer_tpu_torch.native.load_obj_native``)
reads the same subset into raw float32 tables.
"""

from __future__ import annotations

import re

import numpy as np

from .build import euler_xyz

_FACE_RE = re.compile(r"(-?\d+)(?:/(-?\d*)(?:/(-?\d+))?)?")


def load_obj(path: str, pos=(0, 0, 0), rot=(0, 0, 0)):
    """Returns (tri_verts (N,3,3), tri_normals (N,3,3) | zeros, tri_uvs
    (N,3,2)), float64.  Vertex normals are zero rows when the file gives
    none, which the renderer reads as "use the face normal"."""
    verts, uvs, normals = [], [], []
    fv, ft, fn = [], [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("vn "):
                parts = line.split()
                normals.append([float(parts[1]), float(parts[2]),
                                float(parts[3])])
            elif line.startswith("f "):
                refs = _FACE_RE.findall(line[2:])
                if len(refs) < 3:
                    continue
                for k in range(1, len(refs) - 1):      # fan triangulation
                    tri = (refs[0], refs[k], refs[k + 1])
                    fv.append([int(r[0]) for r in tri])
                    ft.append([int(r[1]) if r[1] else 0 for r in tri])
                    fn.append([int(r[2]) if r[2] else 0 for r in tri])

    V = np.asarray(verts, np.float64).reshape(-1, 3)
    UV = (np.asarray(uvs, np.float64).reshape(-1, 2) if uvs
          else np.zeros((1, 2)))
    N = (np.asarray(normals, np.float64).reshape(-1, 3) if normals
         else np.zeros((1, 3)))

    R = euler_xyz(*rot)
    V = V @ R.T + np.asarray(pos, np.float64)
    N = N @ R.T

    def fix(idx, count):
        """1-based -> 0-based; negative counts from the end; 0 -> -1."""
        idx = np.asarray(idx, np.int64)
        return np.where(idx > 0, idx - 1, np.where(idx < 0, count + idx, -1))

    fv = fix(fv, len(verts)) if fv else np.zeros((0, 3), np.int64)
    ft = fix(ft, len(uvs))
    fn = fix(fn, len(normals))

    tri_v = V[fv]                                         # (F,3,3)
    tri_uv = np.where((ft >= 0)[..., None], UV[np.maximum(ft, 0)], 0.0)
    tri_n = np.where((fn >= 0)[..., None], N[np.maximum(fn, 0)], 0.0)
    return tri_v, tri_n, tri_uv
