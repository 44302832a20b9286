"""The superchunk trace (K4): CUDA kernel wrapper + plain version.

Counterpart of ``gi_raytracer_tpu.ops.pallas_intersect._stream_kernel``
(launched by ``_stream_trace`` for scenes past ``VMEM_TRI_CAP``).  It
answers the query of the dense trace (``cuda_intersect``): per ray, the
accepted triangle with the smallest approximate t below the ray's t limit,
ties to the smallest prim id, or with ``any_hit`` whether one lies in
(0, t_lim); the same feature rows, accept test, bfloat16-rounded
reciprocal and stochastic-alpha stream (keyed on the caller's ray ids and
the global prim id).  What it adds is that it does not test what cannot
win:

* a **superchunk** is 2,048 consecutive rows of the BVH-leaf-ordered
  feature table; its box (``build_superchunk_boxes``, (8, n_sc): lo xyz,
  hi xyz, 2 pad rows) bounds its triangles' vertices;
* a **tile** is 256 consecutive rays of the caller (the renderer's 16x16
  pixel blocks, so a narrow frustum).  Each ray's slab entry to every box
  (against its own t limit; culled = BIG) is reduced to the tile's minimum
  per superchunk;
* the tile walks its superchunks in ascending entry order (ties by index)
  and stops at the first whose entry exceeds the tile's cap: the largest
  min(best t, t limit) over its active rays, or for any-hit the largest t
  limit of its active rays still without a hit, refreshed after each
  visit;
* in a visited superchunk a ray skips the test when its own entry is
  culled or (closest hit) beyond its best t so far; any hit stops at its
  first accepted triangle.

Per tile it counts the superchunks visited and the ray-triangle tests
made (``return_counts``): the work the walk needed.

The entry bound is exact but the ordering t is approximate (about 2^-8
relative), so where two hits lie that close across a superchunk boundary
the walk can keep another winner than the brute force; the comparisons
count such lanes.  Hits are not capped at the world-box diagonal.

``prim_query_stream`` is the wrapper: on CPU tensors it runs
:func:`prim_query_stream_plain` (the same walk in torch, vectorised over
tiles); on CUDA tensors it launches ``csrc/stream.cu`` or raises.
"""

from __future__ import annotations

import torch

from . import _cuda
from .cuda_intersect import (BIG, FEAT_W, M32, TRI_PAD, _alpha_uniform,
                             feature_test, ray_terms)

SC_TRIS = 2048            # triangles (feature rows) per superchunk
RAY_TILE = 256            # rays per tile (one CUDA block)
MAX_SC = 2048             # superchunks a tile can order (csrc/stream.cu)
STREAM_TRI_CAP = MAX_SC * SC_TRIS
_PLAIN_PAIRS = 1 << 22    # ray x triangle pairs per plain-version block
_SLAB_TINY = 1e-12


def n_superchunks(t_pad: int) -> int:
    return -(-t_pad // SC_TRIS)


def build_superchunk_boxes(scene, t_pad: int):
    """(8, n_sc) f32 superchunk bounds over the triangles' vertices (v0,
    v0 + e1, v0 + e2): rows lo x, y, z, hi x, y, z, then two zero rows.
    The last superchunk holds the table's remaining rows; its pad rows
    (accept -1, zero features) never pass the test and add no bounds."""
    tr = scene.tris
    T = tr.v0.shape[0]
    n_sc = n_superchunks(t_pad)
    v0 = tr.v0.detach().float()
    verts = torch.stack([v0, v0 + tr.e1.detach().float(),
                         v0 + tr.e2.detach().float()], 1)     # (T, 3, 3)
    pad = n_sc * SC_TRIS - T
    lo = torch.nn.functional.pad(verts.amin(1), (0, 0, 0, pad), value=BIG)
    hi = torch.nn.functional.pad(verts.amax(1), (0, 0, 0, pad), value=-BIG)
    lo = lo.view(n_sc, SC_TRIS, 3).amin(1)
    hi = hi.view(n_sc, SC_TRIS, 3).amax(1)
    box = torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], 1)
    return box.T.contiguous()


def slab_scores(scbox, ro, rd, t_eff):
    """(R, n_sc) slab entry of each ray into each superchunk box,
    max(t_near, 0), or BIG where the ray misses the box or enters it at or
    past its ``t_eff`` (-BIG on inactive lanes)."""
    lo = scbox[0:3].T[None]                     # (1, n_sc, 3)
    hi = scbox[3:6].T[None]
    safe = torch.where(rd.abs() < _SLAB_TINY,
                       torch.where(rd < 0, -_SLAB_TINY, _SLAB_TINY), rd)
    inv = (1.0 / safe)[:, None, :]              # (R, 1, 3)
    o = ro[:, None, :]
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    tn = torch.clamp(torch.minimum(ta, tb).amax(-1), min=-BIG)
    tf = torch.clamp(torch.maximum(ta, tb).amin(-1), max=BIG)
    ent = torch.clamp(tn, min=0.0)
    ok = (tf >= ent) & (ent < t_eff[:, None])
    return torch.where(ok, ent, BIG)


def prim_query_stream_plain(feat, accept, scbox, ro, rd, t_lim, active,
                            ray_id, salt, eps=1e-5, any_hit=False,
                            all_opaque=False, return_counts=False):
    """The superchunk walk in torch: the kernel's tiles, entries, visit
    order, caps, per-ray skip and tie rule, with every visiting tile of a
    step tested at once.  Returns (t_approx (R,) f32, prim (R,) int32), and
    with ``return_counts`` the (n_tiles,) int32 superchunks each tile
    visited and ray-triangle tests it made."""
    _cuda.plain_calls["stream"] += 1
    R = ro.shape[0]
    dev = ro.device
    Tp = feat.shape[0]
    n_sc = scbox.shape[1]
    n_tiles = -(-R // RAY_TILE)
    pad = n_tiles * RAY_TILE - R
    TL = RAY_TILE

    def padded(x, value=0.0):
        return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad),
                                       value=value)

    ro_p = padded(ro.detach().float())
    rd_p = padded(rd.detach().float())
    t_eff = padded(torch.where(active, t_lim.float(), -BIG), -BIG)
    rid = torch.nn.functional.pad(ray_id.to(torch.int64) & M32, (0, pad))
    best_t = torch.full((n_tiles, TL), BIG, dtype=torch.float32, device=dev)
    best_p = torch.full((n_tiles, TL), -1, dtype=torch.int64, device=dev)
    visits = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    tests = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    if R and n_sc:
        score = torch.cat([slab_scores(scbox, ro_p[i:i + 8192],
                                       rd_p[i:i + 8192], t_eff[i:i + 8192])
                           for i in range(0, ro_p.shape[0], 8192)])
        score = score.view(n_tiles, TL, n_sc)
        ent, order = torch.sort(score.amin(1), dim=1, stable=True)
        t_eff = t_eff.view(n_tiles, TL)
        cap = t_eff.amax(1)
        o3, d3 = ro_p.view(n_tiles, TL, 3), rd_p.view(n_tiles, TL, 3)
        rid3 = rid.view(n_tiles, TL, 1)
        arange = torch.arange(SC_TRIS, device=dev)
        blk = max(_PLAIN_PAIRS // (TL * SC_TRIS), 1)
        for v in range(n_sc):
            e = ent[:, v]
            tiles = torch.nonzero((e < BIG) & (e <= cap)).squeeze(1)
            if tiles.numel() == 0:
                break
            visits[tiles] += 1
            for b0 in range(0, tiles.numel(), blk):
                tl = tiles[b0:b0 + blk]
                sc = order[tl, v]
                rows = sc[:, None] * SC_TRIS + arange[None, :]   # (nb, SC)
                real = rows < Tp
                n_real = real.sum(1)[:, None]                    # (nb, 1)
                rows_c = torch.clamp(rows, max=Tp - 1)
                f = feat[rows_c]                                 # (nb, SC, 16)
                tc, ok = feature_test(ray_terms(o3[tl], d3[tl]),
                                      [f[:, None, :, i] for i in range(FEAT_W)],
                                      eps)                       # (nb, TL, SC)
                ok &= real[:, None, :] & (tc < t_eff[tl][..., None])
                own = torch.gather(score[tl], 2,
                                   sc[:, None, None].expand(-1, TL, 1))[..., 0]
                bt, bp = best_t[tl], best_p[tl]
                if any_hit:
                    need = (bp < 0) & (own < BIG)
                else:
                    need = (own < BIG) & (own <= bt)
                ok &= need[..., None]
                if not all_opaque:
                    acc = accept[rows_c][:, None, :]
                    uni = _alpha_uniform(rid3[tl], rows[:, None, :], salt)
                    ok &= (uni < acc) | (acc >= 1.0)
                if any_hit:
                    first = torch.argmax(ok.to(torch.uint8), dim=2)
                    upd = ok.any(2)
                    tt = torch.gather(tc, 2, first[..., None])[..., 0]
                    made = torch.where(upd, first + 1, n_real)
                else:
                    tt, first = torch.where(ok, tc, BIG).min(2)
                    made = n_real.expand_as(need)
                tests[tl] += torch.where(need, made, 0).sum(1)
                p = torch.gather(rows, 1, first)
                if not any_hit:
                    upd = (tt < bt) | ((tt == bt) & (p < bp))
                best_t[tl] = torch.where(upd, tt, bt)
                best_p[tl] = torch.where(upd, p, bp)
            if any_hit:
                need_t = torch.where(best_p[tiles] < 0, t_eff[tiles], -BIG)
            else:
                need_t = torch.minimum(best_t[tiles], t_eff[tiles])
            cap[tiles] = torch.minimum(cap[tiles], need_t.amax(1))
    out = (best_t.view(-1)[:R], best_p.view(-1)[:R].to(torch.int32))
    return out + (visits, tests.to(torch.int32)) if return_counts else out


def prim_query_stream(feat, accept, scbox, ro, rd, t_lim, active, ray_id,
                      salt, eps=1e-5, any_hit=False, all_opaque=False,
                      return_counts=False):
    """(t_approx (R,), prim (R,)) for the winning triangle per ray (-1 =
    miss), and with ``return_counts`` the per-tile visit and test counts.
    ``scbox`` is ``build_superchunk_boxes`` of the table ``feat``."""
    if ro.device.type == "cpu":
        return prim_query_stream_plain(feat, accept, scbox, ro, rd, t_lim,
                                       active, ray_id, salt, eps, any_hit,
                                       all_opaque, return_counts)
    return _stream_cuda(feat, accept, scbox, ro, rd, t_lim, active, ray_id,
                        salt, eps, any_hit, all_opaque, return_counts)


def _stream_cuda(feat, accept, scbox, ro, rd, t_lim, active, ray_id, salt,
                 eps, any_hit, all_opaque, return_counts):
    R = ro.shape[0]
    ro = ro.detach().float().contiguous()
    rd = rd.detach().float().contiguous()
    tl = t_lim.detach().float().contiguous()
    act = active.to(torch.uint8).contiguous()
    rid = (ray_id.to(torch.int64) & M32).to(torch.int32).contiguous() \
        if ray_id.dtype != torch.int32 else ray_id.contiguous()
    _cuda.require_cuda("prim_query_stream", feat, accept, scbox, ro, rd, tl,
                       act, rid)
    if (feat.dim() != 2 or feat.shape[1] != FEAT_W
            or feat.shape[0] % TRI_PAD or feat.dtype != torch.float32
            or accept.dtype != torch.float32
            or scbox.dtype != torch.float32):
        raise ValueError(f"prim_query_stream: feature table "
                         f"{tuple(feat.shape)} {feat.dtype}, accept "
                         f"{accept.dtype}, boxes {scbox.dtype}")
    n_sc = n_superchunks(feat.shape[0])
    if n_sc > MAX_SC:
        raise ValueError(f"prim_query_stream: {feat.shape[0]} triangle rows "
                         f"exceed the kernel's {STREAM_TRI_CAP}")
    _cuda.require_shape("prim_query_stream accept", accept, (feat.shape[0],))
    _cuda.require_shape("prim_query_stream boxes", scbox, (8, n_sc))
    for what, t, shape in (("ro", ro, (R, 3)), ("rd", rd, (R, 3)),
                           ("t_lim", tl, (R,)), ("active", act, (R,)),
                           ("ray_id", rid, (R,))):
        _cuda.require_shape(f"prim_query_stream {what}", t, shape)
    n_tiles = -(-R // RAY_TILE)
    out_t = torch.empty(R, dtype=torch.float32, device=ro.device)
    out_p = torch.empty(R, dtype=torch.int32, device=ro.device)
    visits = torch.empty(n_tiles, dtype=torch.int32, device=ro.device)
    tests = torch.empty(n_tiles, dtype=torch.int32, device=ro.device)
    if R:
        code = _cuda.lib().gi_stream_launch(
            ro.data_ptr(), rd.data_ptr(), tl.data_ptr(), act.data_ptr(),
            rid.data_ptr(), feat.data_ptr(), accept.data_ptr(),
            scbox.data_ptr(), R, feat.shape[0], n_sc, int(salt) & M32,
            float(eps), int(bool(any_hit)), int(bool(all_opaque)),
            out_t.data_ptr(), out_p.data_ptr(), visits.data_ptr(),
            tests.data_ptr(), _cuda.stream_ptr(ro.device))
        _cuda.check(code, "gi_stream_launch")
        _cuda.launches["stream"] += 1
    return (out_t, out_p, visits, tests) if return_counts else (out_t, out_p)
