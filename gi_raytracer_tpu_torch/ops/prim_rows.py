"""The packed prim rows that ``render.shading`` and the kernels read.

The 64-column ``PR_*`` layout is the JAX package's (its
``render.shading``), column for column.  Sphere and cone rows reuse the
geometry columns: a sphere's centre and radius, a cone's base centre,
radius, height and world->local rotation.  The texture descriptor carries
the atlas offset as two exact float halves (hi * 4096 + lo), since one
float32 column loses texels past 2^24.
"""

from __future__ import annotations

import torch

from ..scene.types import Scene, Textures, derived
from .cuda_intersect import TRI_PAD

PR_V0 = 0        # tri v0           | sphere/cone pos
PR_E1 = 3        # tri e1           | sphere rad (col 3) | cone rad 3, h 4
PR_E2 = 6
PR_W2L = 5       # cone world->local rotation, row-major (cols 5:14)
PR_N0, PR_N1, PR_N2 = 9, 12, 15
PR_UV0, PR_UV1, PR_UV2 = 18, 20, 22
PR_FACEN = 24
PR_HASVN = 27
PR_ROUGH, PR_OPAC, PR_IOR = 28, 29, 30
PR_TEXD = 31     # diffuse texture descriptor (14 cols)
PR_TEXE = 45     # emissive texture descriptor (14 cols)
PR_W = 64
TEXD_W = 14
# descriptor: kind, off_hi, off_lo, width, height, has_alpha, tile_u,
#             tile_v, c0 c1 c2, d0 d1 d2


def _tex_descriptor(tx: Textures, tid, dt):
    """(N, 14) descriptor rows for texture ids ``tid``."""
    tid = tid.long()
    return torch.cat([
        tx.kind[tid, None].to(dt),
        torch.div(tx.offset[tid], 4096, rounding_mode="floor")[:, None].to(dt),
        torch.remainder(tx.offset[tid], 4096)[:, None].to(dt),
        tx.width[tid, None].to(dt),
        tx.height[tid, None].to(dt),
        tx.has_alpha[tid, None].to(dt),
        tx.tiles[tid].to(dt),
        tx.color[tid].to(dt),
        tx.color2[tid].to(dt),
    ], dim=1)


def build_prim_rows(scene: Scene) -> torch.Tensor:
    """(T + S + C, PR_W) packed shade rows for every primitive: triangles,
    then spheres, then cones."""
    m = scene.materials
    dt = scene.tris.v0.dtype if scene.n_tris else m.roughness.dtype
    dev = m.roughness.device
    parts = []

    def mat_cols(mat_id):
        mid = mat_id.long()
        return [m.roughness[mid, None].to(dt), m.opacity[mid, None].to(dt),
                m.ior[mid, None].to(dt),
                _tex_descriptor(scene.textures, m.diffuse_tex[mid], dt),
                _tex_descriptor(scene.textures, m.emissive_tex[mid], dt)]

    if scene.n_tris:
        tr = scene.tris
        has_vn = ((torch.sum(tr.n0 * tr.n0, -1) > 0)
                  & (torch.sum(tr.n1 * tr.n1, -1) > 0)
                  & (torch.sum(tr.n2 * tr.n2, -1) > 0))
        parts.append(torch.cat([
            tr.v0, tr.e1, tr.e2, tr.n0, tr.n1, tr.n2, tr.uv0, tr.uv1, tr.uv2,
            tr.face_n, has_vn[:, None].to(dt)] + mat_cols(tr.mat_id), dim=1))
    if scene.n_spheres:
        sp = scene.spheres
        parts.append(torch.cat([
            sp.pos.to(dt), sp.rad[:, None].to(dt),
            torch.zeros((sp.count, 24), dtype=dt, device=dev)]
            + mat_cols(sp.mat_id), dim=1))
    if scene.n_cones:
        cn = scene.cones
        C = cn.count
        parts.append(torch.cat([
            cn.pos.to(dt), cn.rad[:, None].to(dt), cn.height[:, None].to(dt),
            cn.w2l.reshape(C, 9).to(dt),
            torch.zeros((C, 14), dtype=dt, device=dev)]
            + mat_cols(cn.mat_id), dim=1))
    if not parts:
        parts = [torch.zeros((1, 28 + 3 + 2 * TEXD_W), dtype=dt, device=dev)]
    rows = torch.cat(parts, 0)
    return torch.nn.functional.pad(rows, (0, PR_W - rows.shape[1]))


def kernel_rows(scene: Scene) -> torch.Tensor:
    """(T_pad, PR_W) float32 rows for the kernels (K1, the photon round),
    kept on the scene (``types.derived``).  Pad rows set PR_IOR to 1 (with
    opacity 0 the accept probability is 0) and have zero geometry, so they
    never pass the test."""
    def build():
        rows = build_prim_rows(scene).detach().float()
        pad = (-rows.shape[0]) % TRI_PAD
        if pad:
            prow = torch.zeros((pad, PR_W), dtype=rows.dtype,
                               device=rows.device)
            prow[:, PR_IOR] = 1.0
            rows = torch.cat([rows, prow], 0)
        return rows.contiguous()
    return derived(scene, "_kernel_rows", scene.table_sources(), build)
