"""Surface shading: hit attributes from packed prim rows, BSDF direction
select.

Counterpart of ``gi_raytracer_tpu.render.shading``: triangles, analytic
spheres and cones; constant, checker and image textures.  The rows are
``ops.prim_rows``'s.  An image texel is fetched from the flat atlas with
the V flip and tiling of the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.intersect import cone_attrs, cone_frame_attrs
from ..ops.prim_rows import (PR_FACEN, PR_HASVN, PR_IOR, PR_N0, PR_N1, PR_N2,
                             PR_OPAC, PR_ROUGH, PR_TEXD, PR_TEXE, PR_UV0,
                             PR_UV1, PR_UV2, PR_V0, PR_W2L, TEXD_W)
from ..scene.types import Scene, Textures, TEX_CHECKER, TEX_IMAGE
from .geom import dot, reflect, refract_tir, hemisphere_cos, sample_phong

def _image_texel(atlas, offset, w, h, tlu, tlv, u, v):
    """Texel of an image texture at (u, v): x = |(int)(u*w*tile_u) % w|,
    y = h - |(int)(v*h*tile_v) % h| - 1, from the flat atlas at ``offset``
    (int32 tensors ``offset``, ``w``, ``h``)."""
    wf, hf = w.to(u.dtype), h.to(u.dtype)
    xi = torch.abs(torch.remainder(torch.trunc(u * wf * tlu).to(torch.int32),
                                   torch.clamp(w, min=1)))
    yi_raw = torch.abs(torch.remainder(
        torch.trunc(v * hf * tlv).to(torch.int32), torch.clamp(h, min=1)))
    yi = h - yi_raw - 1
    flat = torch.clamp(offset + yi * w + xi, 0, atlas.shape[0] - 1)
    return atlas[flat.long()]


def _tex_eval_desc(scene: Scene, desc, u, v):
    """(rgb (R,3), alpha (R,)) from gathered 14-col descriptors."""
    kind = desc[..., 0]
    const_rgb = desc[..., 8:11]
    color2 = desc[..., 11:14]
    tlu, tlv = desc[..., 6], desc[..., 7]
    iu = torch.trunc(u * tlu)
    iv = torch.trunc(v * tlv)
    even_u = torch.remainder(torch.abs(iu), 2.0) < 0.5
    even_v = torch.remainder(torch.abs(iv), 2.0) < 0.5
    checker_rgb = torch.where((even_u ^ even_v)[..., None], const_rgb, color2)
    rgb = torch.where((kind == TEX_CHECKER)[..., None], checker_rgb, const_rgb)
    alpha = torch.ones_like(u)
    if scene.has_image_tex:
        offset = (desc[..., 1].to(torch.int32) * 4096
                  + desc[..., 2].to(torch.int32))
        texel = _image_texel(scene.textures.atlas, offset,
                             desc[..., 3].to(torch.int32),
                             desc[..., 4].to(torch.int32), tlu, tlv, u, v)
        is_img = kind == TEX_IMAGE
        rgb = torch.where(is_img[..., None], texel[..., :3], rgb)
        alpha = torch.where(is_img & (desc[..., 5] > 0.5), texel[..., 3],
                            alpha)
    return rgb, alpha


class ShadeResult(NamedTuple):
    point: torch.Tensor     # (R, 3)
    normal: torch.Tensor    # (R, 3) un-flipped shading normal
    uv: torch.Tensor        # (R, 2)
    valid: torch.Tensor     # (R,)
    color: torch.Tensor     # (R, 3)
    emissive: torch.Tensor  # (R, 3)
    alpha: torch.Tensor     # (R,)
    rough: torch.Tensor     # (R,)
    ior: torch.Tensor       # (R,)


def shade_from_rows(scene: Scene, row, ro, rd, t, prim, bu, bv) -> ShadeResult:
    """All per-hit shading inputs from ONE pre-gathered prim row (the row
    of the final winning primitive)."""
    valid = prim >= 0
    t_safe = torch.where(valid, t, 0.0)
    point = ro + t_safe[:, None] * rd
    n0 = row[:, PR_N0:PR_N0 + 3]
    n1 = row[:, PR_N1:PR_N1 + 3]
    n2 = row[:, PR_N2:PR_N2 + 3]
    has_vn = row[:, PR_HASVN] > 0.5
    w0 = (1.0 - bu - bv)[:, None]
    n_interp = w0 * n0 + bu[:, None] * n1 + bv[:, None] * n2
    normal = torch.where(has_vn[:, None], n_interp,
                         row[:, PR_FACEN:PR_FACEN + 3])
    uv = w0 * row[:, PR_UV0:PR_UV0 + 2] + bu[:, None] * row[:, PR_UV1:PR_UV1 + 2] \
        + bv[:, None] * row[:, PR_UV2:PR_UV2 + 2]
    uv = torch.where(has_vn[:, None], uv, torch.zeros_like(uv))

    # sphere / cone lanes override the geometry columns kind-dependently
    if scene.n_spheres:
        is_sph = (prim >= scene.n_tris) & (prim < scene.n_tris
                                           + scene.n_spheres)
        c = row[:, PR_V0:PR_V0 + 3]
        rad = torch.where(row[:, 3] != 0, row[:, 3], 1.0)
        sph_n, sph_uv = _sphere_attrs(point, c, rad)
        normal = torch.where(is_sph[:, None], sph_n, normal)
        uv = torch.where(is_sph[:, None], sph_uv, uv)
    if scene.n_cones:
        is_cone = prim >= scene.n_tris + scene.n_spheres
        ch = torch.where(row[:, 4] != 0, row[:, 4], 1.0)
        w2l = row[:, PR_W2L:PR_W2L + 9].reshape(-1, 3, 3)
        cone_n, cone_uv = cone_frame_attrs(point, row[:, PR_V0:PR_V0 + 3], ch,
                                           w2l)
        normal = torch.where(is_cone[:, None], cone_n, normal)
        uv = torch.where(is_cone[:, None], cone_uv, uv)

    rough = row[:, PR_ROUGH]
    opac = row[:, PR_OPAC]
    ior = row[:, PR_IOR]
    color, ta = _tex_eval_desc(scene, row[:, PR_TEXD:PR_TEXD + TEXD_W],
                               uv[:, 0], uv[:, 1])
    em, _ = _tex_eval_desc(scene, row[:, PR_TEXE:PR_TEXE + TEXD_W],
                           uv[:, 0], uv[:, 1])
    return ShadeResult(point, normal, uv, valid, color, em, opac * ta,
                       rough, ior)


def _sphere_attrs(point, c, rad):
    """Sphere (normal, uv) at world points: the outward normal (not
    re-normalised) and the reference's spherical uv."""
    sph_n = (point - c) / rad[:, None]
    d = (c - point) / rad[:, None]
    sv = 0.5 + torch.asin(torch.clamp(d[:, 1], -1, 1)) / torch.pi
    su = 0.5 + torch.atan2(d[:, 2], d[:, 0]) / (2 * torch.pi)
    return sph_n, torch.stack([su, sv], -1)


def sample_texture(tex: Textures, tid, uv):
    """(rgb (R,3), alpha (R,)) for texture ids ``tid`` at ``uv``
    (checkerboard parity; image fetch with V flip and tiling)."""
    tid = tid.long()
    u, v = uv[..., 0], uv[..., 1]
    kind = tex.kind[tid]
    const_rgb = tex.color[tid]
    tl = tex.tiles[tid]
    iu = torch.trunc(u * tl[..., 0])
    iv = torch.trunc(v * tl[..., 1])
    even_u = torch.remainder(torch.abs(iu), 2.0) < 0.5
    even_v = torch.remainder(torch.abs(iv), 2.0) < 0.5
    checker_rgb = torch.where((even_u ^ even_v)[..., None],
                              tex.color[tid], tex.color2[tid])
    texel = _image_texel(tex.atlas, tex.offset[tid], tex.width[tid],
                         tex.height[tid], tl[..., 0], tl[..., 1], u, v)
    is_img = kind == TEX_IMAGE
    rgb = torch.where(is_img[..., None], texel[..., :3],
                      torch.where((kind == TEX_CHECKER)[..., None],
                                  checker_rgb, const_rgb))
    alpha = torch.where(is_img & tex.has_alpha[tid], texel[..., 3], 1.0)
    return rgb, alpha


def material_lookup(scene: Scene, mat_id, uv):
    """(diffuse rgb, emissive rgb, alpha=opacity*tex_alpha, roughness, ior)
    for hit materials."""
    m = scene.materials
    mid = mat_id.long()
    rgb, ta = sample_texture(scene.textures, m.diffuse_tex[mid], uv)
    em, _ = sample_texture(scene.textures, m.emissive_tex[mid], uv)
    return rgb, em, m.opacity[mid] * ta, m.roughness[mid], m.ior[mid]


class HitAttrs(NamedTuple):
    point: torch.Tensor
    normal: torch.Tensor
    uv: torch.Tensor
    mat_id: torch.Tensor
    valid: torch.Tensor


def hit_attributes_uv(scene: Scene, ro, rd, t, prim, bu, bv) -> HitAttrs:
    """Interpolated position/normal/uv/material for hits: triangles use
    vertex normals when present, the face normal otherwise (interpolated
    normals are deliberately not re-normalized); spheres and cones are
    layered over them."""
    valid = prim >= 0
    p = torch.clamp(prim, 0, max(scene.n_tris + scene.n_spheres
                                 + scene.n_cones - 1, 0))
    t_safe = torch.where(valid, t, 0.0)
    point = ro + t_safe[:, None] * rd
    if scene.n_tris:
        tr = scene.tris
        tp = torch.clamp(p, 0, scene.n_tris - 1).long()
        n0, n1, n2 = tr.n0[tp], tr.n1[tp], tr.n2[tp]
        has_vn = ((torch.sum(n0 * n0, -1) > 0) & (torch.sum(n1 * n1, -1) > 0)
                  & (torch.sum(n2 * n2, -1) > 0))
        w0 = (1.0 - bu - bv)[:, None]
        n_interp = w0 * n0 + bu[:, None] * n1 + bv[:, None] * n2
        normal = torch.where(has_vn[:, None], n_interp, tr.face_n[tp])
        uv = (w0 * tr.uv0[tp] + bu[:, None] * tr.uv1[tp]
              + bv[:, None] * tr.uv2[tp])
        uv = torch.where(has_vn[:, None], uv, torch.zeros_like(uv))
        mat_id = tr.mat_id[tp]
    else:
        normal = torch.zeros_like(point)
        uv = torch.zeros_like(point[:, :2])
        mat_id = torch.zeros(point.shape[0], dtype=torch.int32,
                             device=point.device)
    if scene.n_spheres:
        is_sph = (p >= scene.n_tris) & (p < scene.n_tris + scene.n_spheres)
        sp = torch.clamp(p - scene.n_tris, 0, scene.n_spheres - 1).long()
        sph_n, sph_uv = _sphere_attrs(point, scene.spheres.pos[sp],
                                      scene.spheres.rad[sp])
        normal = torch.where(is_sph[:, None], sph_n, normal)
        uv = torch.where(is_sph[:, None], sph_uv, uv)
        mat_id = torch.where(is_sph, scene.spheres.mat_id[sp], mat_id)
    if scene.n_cones:
        base = scene.n_tris + scene.n_spheres
        cp = torch.clamp(p - base, 0, scene.n_cones - 1)
        cone_n, cone_uv = cone_attrs(scene.cones, point, cp)
        is_cone = p >= base
        normal = torch.where(is_cone[:, None], cone_n, normal)
        uv = torch.where(is_cone[:, None], cone_uv, uv)
        mat_id = torch.where(is_cone, scene.cones.mat_id[cp.long()], mat_id)
    return HitAttrs(point, normal, uv, mat_id, valid)


class Secondary(NamedTuple):
    dir: torch.Tensor         # (R,3) continuation direction
    f: torch.Tensor           # (R,3) path weight for this bounce
    contrib: torch.Tensor     # (R,3) Russian-roulette driver
    normal: torch.Tensor      # (R,3) flipped shading normal
    offset_sign: torch.Tensor  # (R,) +1 reflect/diffuse, -1 refract


def secondary_ray(rd, normal, color, alpha, roughness, ior,
                  sx, sy, u_opacity, u_fresnel, contrib) -> Secondary:
    """BSDF branch select + direction sampling: mirror when roughness <
    .001, stochastic refract-vs-reflect (Schlick) when the opacity lottery
    fails, glossy/diffuse otherwise."""
    backface = dot(normal, rd)[..., 0] > 0
    n = torch.where(backface[:, None], -normal, normal)

    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    refl = reflect(rd, n)
    fs = r0 + (1.0 - r0) * (1.0 - dot(refl, n)[..., 0]) ** 5

    typ = torch.full((rd.shape[0],), 2, dtype=torch.int32, device=rd.device)
    typ = torch.where(roughness < 0.001, 0, typ)
    lottery = u_opacity > alpha
    typ = torch.where(lottery, torch.where(u_fresnel < fs, 0, 1), typ)

    eta = torch.where(backface, ior, 1.0 / ior)[:, None]
    d_refr = refract_tir(rd, n, eta)

    d_diff = hemisphere_cos(n, sx, sy, 2.0)
    phong_pow = 1.0 / torch.clamp(roughness, min=1e-6) + 1.0
    d_phong = sample_phong(refl, phong_pow, sx, sy)
    d_phong = torch.where(dot(d_phong, n)[..., 0:1] < 0,
                          reflect(d_phong, n), d_phong)
    d_gloss = torch.where((roughness < 0.9)[:, None], d_phong, d_diff)

    out = torch.where((typ == 1)[:, None], d_refr,
                      torch.where((typ == 0)[:, None], refl, d_gloss))
    ones = torch.ones_like(color)
    contrib_gloss = 0.5 * (contrib * color + color)
    new_contrib = torch.where((typ == 2)[:, None], contrib_gloss, ones)
    offset_sign = torch.where(typ == 1, -1.0, 1.0).to(rd.dtype)
    return Secondary(out, color, new_contrib, n, offset_sign)
