"""The dense triangle trace (K2): CUDA kernel wrapper + plain version, and
the plain chunk walk that K2 and K4 share.

Counterpart of ``gi_raytracer_tpu.ops.pallas_intersect`` (``_kernel`` via
``_dense_trace``/``pallas_prim_query``).  The query: for each ray, the
accepted triangle with the smallest approximate t below the ray's t limit
(ties to the smallest prim id), or with ``any_hit`` whether one lies in
(0, t_lim).  The accept test is the separable, homogeneous
Moller-Trumbore form of the TPU kernel on per-triangle features
(n2 = e1 x e2, fu = v0 x e2, fv = v0 x e1, d0 = v0 . n2, e1, e2), with the
stochastic-alpha hash keyed on the caller's ray ids unless the scene is
``all_opaque``.  The exact (t, u, v) of the winner is recomputed in torch
(:func:`exact_hit`), so gradients reach the vertices by ordinary autograd.

The trace is a walk (:func:`walk_plain`, ``csrc/walk.cuh``) that does not
test what cannot win:

* a **tile** is ``RAY_TILE`` consecutive rays of the caller (the renderer's
  16x16 pixel blocks, so a narrow frustum); a **chunk** is 128 consecutive
  rows of the BVH-leaf-ordered feature table, with a box over its
  triangles' vertices (:func:`build_boxes`); a **group** is one chunk (K2)
  or sixteen (K4's 2,048-row superchunks), with its own box;
* each ray's slab entry into every group box (against its own t limit;
  culled = BIG) is reduced to the tile's least entry per group, and the
  tile walks the entered groups in ascending entry order (ties by index),
  stopping at the first whose entry exceeds the tile's cap: the largest
  min(best t, t limit) over its active rays, or for any hit the largest t
  limit of its active rays still without a hit, refreshed before each
  visit;
* in a visited group a ray needs the group when its own entry is not
  culled and (closest hit) at or before its best t, or (any hit) it has no
  hit yet, and then each chunk of the group whose box it enters likewise,
  best t as it stood when the visit began; it tests the rows of the chunks
  it needs.  Any hit keeps the least accepted row of the group.

Per tile the walk counts the groups visited and the ray-triangle tests
needed (``return_counts``): 128 for each (ray, chunk) pair, or for any hit
the rows up to and including the chunk's first accepted row.

The box entries are exact but the ordering t is approximate (about 2^-8
relative), so where two hits lie that close across chunks the walk can
keep another winner than the brute force (:func:`prim_query_brute`); the
comparisons count such lanes.  Hits are not capped at the world-box
diagonal.

``prim_query`` is the wrapper: on CPU tensors it runs
:func:`prim_query_plain` (the walk with one chunk per group); on CUDA
tensors it launches ``csrc/intersect.cu`` or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..sampling.rng import bits_to_u01, mul32, _mix, M32
from . import _cuda

BIG = 3.0e38
FEAT_W = 16
TRI_PAD = 128          # feature tables are padded to a multiple of this
CHUNK_ROWS = 128       # rows per chunk (csrc/walk.cuh GI_CHUNK)
RAY_TILE = 256         # rays per tile, one CUDA block (GI_TILE)
MAX_GROUPS = 2048      # groups a tile can order (GI_MAX_GROUPS)
_PLAIN_BLOCK = 1 << 22   # ray x triangle pairs per plain-version block
_SLAB_TINY = 1e-12


def build_tri_features(scene):
    """((T_pad, 16) f32 features [n2, fu, fv, d0, e1, e2], (T_pad,) f32
    accept probability) from the scene's (BVH-leaf-ordered) triangles.
    Pad rows are all zero (never pass the test) with accept -1."""
    tr = scene.tris
    T = tr.v0.shape[0]
    pad = (-T) % TRI_PAD
    v0 = tr.v0.detach().float()
    e1 = tr.e1.detach().float()
    e2 = tr.e2.detach().float()
    n2 = torch.linalg.cross(e1, e2)
    fu = torch.linalg.cross(v0, e2)
    fv = torch.linalg.cross(v0, e1)
    d0 = torch.sum(v0 * n2, dim=1, keepdim=True)
    feat = torch.cat([n2, fu, fv, d0, e1, e2], dim=1)
    feat = torch.nn.functional.pad(feat, (0, 0, 0, pad))
    mid = tr.mat_id.long()
    m = scene.materials
    accept = torch.where(m.ior[mid] != 1.0, 1.0, m.opacity[mid]).detach()
    accept = torch.nn.functional.pad(accept.float(), (0, pad), value=-1.0)
    return feat.contiguous(), accept.contiguous()


def build_boxes(scene, t_pad: int, rows: int):
    """(8, n) f32 bounds of the triangles' vertices (v0, v0 + e1, v0 + e2)
    in each group of ``rows`` consecutive rows of the ``t_pad``-row table:
    rows lo x, y, z, hi x, y, z, then two zero rows.  The last group holds
    the table's remaining rows; its pad rows (accept -1, zero features)
    never pass the test and add no bounds.  ``rows`` = ``CHUNK_ROWS`` gives
    the chunk boxes, which K2 and K4 walk."""
    tr = scene.tris
    T = tr.v0.shape[0]
    n = -(-t_pad // rows)
    v0 = tr.v0.detach().float()
    verts = torch.stack([v0, v0 + tr.e1.detach().float(),
                         v0 + tr.e2.detach().float()], 1)     # (T, 3, 3)
    pad = n * rows - T
    lo = torch.nn.functional.pad(verts.amin(1), (0, 0, 0, pad), value=BIG)
    hi = torch.nn.functional.pad(verts.amax(1), (0, 0, 0, pad), value=-BIG)
    lo = lo.view(n, rows, 3).amin(1)
    hi = hi.view(n, rows, 3).amax(1)
    box = torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], 1)
    return box.T.contiguous()


def _slab_entry(lo, hi, o, inv, t_eff):
    """Slab entry max(t_near, 0) of rays (o, inv: (..., 3)) into boxes (lo,
    hi: (..., 3), broadcast against them), or BIG where the ray misses the
    box or enters it at or past ``t_eff`` (the kernels' gi_slab_score)."""
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    tn = torch.clamp(torch.minimum(ta, tb).amax(-1), min=-BIG)
    tf = torch.clamp(torch.maximum(ta, tb).amin(-1), max=BIG)
    ent = torch.clamp(tn, min=0.0)
    ok = (tf >= ent) & (ent < t_eff)
    return torch.where(ok, ent, BIG)


def _safe_inv(rd):
    return 1.0 / torch.where(rd.abs() < _SLAB_TINY,
                             torch.where(rd < 0, -_SLAB_TINY, _SLAB_TINY), rd)


def slab_scores(box, ro, rd, t_eff):
    """(R, n) slab entry of each ray into each box of an (8, n) table,
    max(t_near, 0), or BIG where the ray misses the box or enters it at or
    past its ``t_eff`` (-BIG on inactive lanes)."""
    return _slab_entry(box[0:3].T[None], box[3:6].T[None], ro[:, None, :],
                       _safe_inv(rd)[:, None, :], t_eff[:, None])


def approx_reciprocal(x):
    """The TPU kernels order hits by ``t_num * pl.reciprocal(det,
    approx=True)``; off the TPU the JAX reference computes that reciprocal
    as the float32 1/x of x rounded to bfloat16 (round to nearest even).
    The port reproduces it bit for bit (also in ``csrc/common.cuh``), so the
    same triangle wins near-ties; the winner's exact t is recomputed."""
    return 1.0 / x.to(torch.bfloat16).float()


def _alpha_uniform(rid, prim, salt):
    """The TPU kernel's alpha stream: mix(rid*K ^ mix((prim + C) ^ salt))
    as a [0, 1) float (rid, prim: int64 uint32 values)."""
    h = _mix(mul32(rid, 0x9E3779B9)
             ^ _mix(((prim + 0x7F4A7C15) & M32) ^ (salt & M32)))
    return bits_to_u01(h)


def ray_terms(o, d):
    """(ox, oy, oz, dx, dy, dz, cxx, cxy, cxz) of rays o, d (..., 3): the
    components and ro x rd, each with a trailing axis of 1 for the test's
    broadcast against a row of triangles."""
    ox, oy, oz = (o[..., i:i + 1] for i in range(3))
    dx, dy, dz = (d[..., i:i + 1] for i in range(3))
    return (ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
            ox * dy - oy * dx)


def feature_test(ray, f, eps):
    """The kernels' separable Moller-Trumbore test of rays (``ray_terms``)
    against triangles whose 16 feature components are ``f[0..15]``
    (broadcastable).  Returns (approximate t, geometric accept)."""
    ox, oy, oz, dx, dy, dz, cxx, cxy, cxz = ray
    n2x, n2y, n2z, fux, fuy, fuz, fvx, fvy, fvz, d0, \
        e1x, e1y, e1z, e2x, e2y, e2z = f
    m = dx * n2x + dy * n2y + dz * n2z
    sm = torch.where(m >= 0.0, 1.0, -1.0)
    ds = m * sm
    ns = -sm
    u_num = ((cxx * e2x + cxy * e2y + cxz * e2z)
             + (dx * fux + dy * fuy + dz * fuz))
    v_sum = ((cxx * e1x + cxy * e1y + cxz * e1z)
             + (dx * fvx + dy * fvy + dz * fvz))
    t_num = (ox * n2x + oy * n2y + oz * n2z) - d0
    us = u_num * ns
    vs = v_sum * sm
    ts = t_num * ns
    ok = ((ds >= eps) & (us >= 0.0) & (vs >= 0.0)
          & (us + vs <= ds) & (ts > 0.0))
    return ts * approx_reciprocal(torch.clamp(ds, min=1e-30)), ok


def walk_plain(feat, accept, gbox, cbox, ro, rd, t_lim, active, ray_id,
               salt, eps, any_hit, all_opaque, return_counts, group_rows,
               chunk_rows=CHUNK_ROWS):
    """The kernels' walk in torch, vectorised over tiles: every tile that
    visits at the same step of its walk is tested at once.  ``gbox`` holds
    the boxes of ``group_rows``-row groups and ``cbox`` of ``chunk_rows``-row
    chunks (``build_boxes``); ``chunk_rows`` = ``group_rows`` tests whole
    groups (then ``cbox`` is ``gbox``).  Returns (t_approx (R,) f32, prim
    (R,) int32), and with ``return_counts`` the (n_tiles,) int32 groups each
    tile visited and ray-triangle tests it needed."""
    R = ro.shape[0]
    dev = ro.device
    Tp = feat.shape[0]
    n_g, n_c = gbox.shape[1], cbox.shape[1]
    G, C = group_rows, chunk_rows
    GC = G // C
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
    if R and n_g:
        score = torch.cat([slab_scores(gbox, ro_p[i:i + 8192],
                                       rd_p[i:i + 8192], t_eff[i:i + 8192])
                           for i in range(0, ro_p.shape[0], 8192)])
        score = score.view(n_tiles, TL, n_g)
        ent, order = torch.sort(score.amin(1), dim=1, stable=True)
        t_eff = t_eff.view(n_tiles, TL)
        cap = t_eff.amax(1)
        o3, d3 = ro_p.view(n_tiles, TL, 3), rd_p.view(n_tiles, TL, 3)
        inv3 = _safe_inv(d3)
        rid3 = rid.view(n_tiles, TL, 1)
        arange = torch.arange(G, device=dev)
        carange = torch.arange(GC, device=dev)
        # on the card, blocks four times larger: fewer small launches
        pairs = _PLAIN_BLOCK * (4 if ro.is_cuda else 1)
        blk = max(pairs // (TL * G), 1)
        for v in range(n_g):
            e = ent[:, v]
            tiles = torch.nonzero((e < BIG) & (e <= cap)).squeeze(1)
            if tiles.numel() == 0:
                break
            visits[tiles] += 1
            for b0 in range(0, tiles.numel(), blk):
                tl = tiles[b0:b0 + blk]
                nb = tl.numel()
                g = order[tl, v]
                rows = g[:, None] * G + arange[None, :]          # (nb, G)
                rows_c = torch.clamp(rows, max=Tp - 1)
                f = feat[rows_c]                                 # (nb, G, 16)
                te = t_eff[tl]                                   # (nb, TL)
                tc, ok = feature_test(ray_terms(o3[tl], d3[tl]),
                                      [f[:, None, :, i] for i in range(FEAT_W)],
                                      eps)                       # (nb, TL, G)
                ok &= (rows < Tp)[:, None, :] & (tc < te[..., None])
                own = torch.gather(score[tl], 2,
                                   g[:, None, None].expand(-1, TL, 1))[..., 0]
                bt, bp = best_t[tl], best_p[tl]
                need = (own < BIG) & ((bp < 0) if any_hit else (own <= bt))
                # the chunks of the group each ray needs (nb, TL, GC)
                chunk = g[:, None] * GC + carange[None, :]       # (nb, GC)
                if GC == 1:
                    need_c = need[..., None]
                else:
                    box = cbox[:, torch.clamp(chunk, max=n_c - 1)]  # (8,nb,GC)
                    lo = box[0:3].permute(1, 2, 0)[:, None]      # (nb,1,GC,3)
                    hi = box[3:6].permute(1, 2, 0)[:, None]
                    ce = _slab_entry(lo, hi, o3[tl][:, :, None],
                                     inv3[tl][:, :, None], te[..., None])
                    need_c = (need[..., None] & (chunk < n_c)[:, None, :]
                              & (ce < BIG))
                    if not any_hit:
                        need_c &= ce <= bt[..., None]
                ok = (ok.view(nb, TL, GC, C) & need_c[..., None]) \
                    .view(nb, TL, G)
                if not all_opaque:
                    acc = accept[rows_c][:, None, :]
                    uni = _alpha_uniform(rid3[tl], rows[:, None, :], salt)
                    ok &= (uni < acc) | (acc >= 1.0)
                n_real = torch.clamp(Tp - chunk * C, 0, C)[:, None, :]
                if any_hit:
                    okc = ok.view(nb, TL, GC, C)
                    made = torch.where(okc.any(3),
                                       torch.argmax(okc.to(torch.uint8), 3)
                                       + 1, n_real)
                    first = torch.argmax(ok.to(torch.uint8), dim=2)
                    upd = ok.any(2)
                    tt = torch.gather(tc, 2, first[..., None])[..., 0]
                else:
                    tt, first = torch.where(ok, tc, BIG).min(2)
                    made = n_real.expand(nb, TL, GC)
                tests[tl] += torch.where(need_c, made, 0).sum((1, 2))
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


def prim_query_plain(feat, accept, cbox, ro, rd, t_lim, active, ray_id, salt,
                     eps=1e-5, any_hit=False, all_opaque=False,
                     return_counts=False):
    """K2's plain version: the walk with one 128-row chunk per group
    (``cbox`` = ``build_boxes(scene, t_pad, CHUNK_ROWS)``)."""
    _cuda.plain_calls["intersect"] += 1
    return walk_plain(feat, accept, cbox, cbox, ro, rd, t_lim, active,
                      ray_id, salt, eps, any_hit, all_opaque, return_counts,
                      CHUNK_ROWS)


def prim_query_brute(feat, accept, ro, rd, t_lim, active, ray_id, salt,
                     eps=1e-5, any_hit=False, all_opaque=False):
    """The brute-force reference of both traces: every ray against every
    triangle, in blocks, with the kernels' accept test and tie rule.
    Returns (t_approx (R,) f32 (BIG on miss), prim (R,) int32); any hit
    keeps the first accepted triangle in index order."""
    R = ro.shape[0]
    Tp = feat.shape[0]
    dev = ro.device
    best_t = torch.full((R,), BIG, dtype=torch.float32, device=dev)
    best_p = torch.full((R,), -1, dtype=torch.int32, device=dev)
    if R == 0 or Tp == 0:
        return best_t, best_p
    t_eff = torch.where(active, t_lim.float(), -BIG)
    rid_all = ray_id.to(torch.int64) & M32
    tb = min(Tp, 4096)
    rb = max(_PLAIN_BLOCK // tb, 1)
    for r0 in range(0, R, rb):
        r1 = min(r0 + rb, R)
        ray = ray_terms(ro[r0:r1].float(), rd[r0:r1].float())
        te = t_eff[r0:r1, None]
        rid = rid_all[r0:r1, None]
        for t0 in range(0, Tp, tb):
            t1 = min(t0 + tb, Tp)
            f = feat[t0:t1].T
            tc, ok = feature_test(ray, [f[i:i + 1] for i in range(FEAT_W)],
                                  eps)
            ok &= tc < te
            if not all_opaque:
                acc = accept[None, t0:t1]
                prim = torch.arange(t0, t1, device=dev, dtype=torch.int64)
                uni = _alpha_uniform(rid, prim[None, :], salt)
                ok &= (uni < acc) | (acc >= 1.0)
            sl = slice(r0, r1)
            if any_hit:
                has = ok.any(dim=1)
                first = torch.argmax(ok.to(torch.uint8), dim=1)
                tt = torch.gather(tc, 1, first[:, None])[:, 0]
                upd = has & (best_p[sl] < 0)
            else:
                tt_all = torch.where(ok, tc, BIG)
                tt, first = torch.min(tt_all, dim=1)
                upd = tt < best_t[sl]
            best_t[sl] = torch.where(upd, tt, best_t[sl])
            best_p[sl] = torch.where(upd, (first + t0).to(torch.int32),
                                     best_p[sl])
    return best_t, best_p


def prim_query(feat, accept, cbox, ro, rd, t_lim, active, ray_id, salt,
               eps=1e-5, any_hit=False, all_opaque=False, return_counts=False):
    """(t_approx (R,), prim (R,)) for the winning triangle per ray (-1 =
    miss), and with ``return_counts`` the per-tile visit and test counts.
    ``cbox`` is ``build_boxes(scene, t_pad, CHUNK_ROWS)`` of the table
    ``feat``; ``t_lim`` (R,) f32, ``active`` (R,) bool, ``ray_id`` (R,)
    ints keying the alpha stream, ``salt`` a uint32 int."""
    if ro.device.type == "cpu":
        return prim_query_plain(feat, accept, cbox, ro, rd, t_lim, active,
                                ray_id, salt, eps, any_hit, all_opaque,
                                return_counts)
    n_c = feat.shape[0] // CHUNK_ROWS
    return walk_cuda("prim_query", "intersect", feat, accept, (cbox,), n_c,
                     ro, rd, t_lim, active, ray_id, salt, eps, any_hit,
                     all_opaque, return_counts)


def walk_cuda(name, kernel, feat, accept, boxes, n_groups, ro, rd, t_lim,
              active, ray_id, salt, eps, any_hit, all_opaque, return_counts):
    """Check the inputs of a walk kernel (``kernel`` "intersect": K2,
    "stream": K4) and launch it; ``boxes`` are its box tables, the first
    with ``n_groups`` columns, the last the chunk boxes."""
    R = ro.shape[0]
    ro = ro.detach().float().contiguous()
    rd = rd.detach().float().contiguous()
    tl = t_lim.detach().float().contiguous()
    act = active.to(torch.uint8).contiguous()
    rid = (ray_id.to(torch.int64) & M32).to(torch.int32).contiguous() \
        if ray_id.dtype != torch.int32 else ray_id.contiguous()
    _cuda.require_cuda(name, feat, accept, *boxes, ro, rd, tl, act, rid)
    if (feat.dim() != 2 or feat.shape[1] != FEAT_W
            or feat.shape[0] % TRI_PAD or feat.dtype != torch.float32
            or accept.dtype != torch.float32
            or any(b.dtype != torch.float32 for b in boxes)
            or feat.data_ptr() % 16 or accept.data_ptr() % 16):
        raise ValueError(f"{name}: feature table {tuple(feat.shape)} "
                         f"{feat.dtype}, accept {accept.dtype}, boxes "
                         f"{[b.dtype for b in boxes]} (16-byte aligned "
                         f"float32 tables)")
    if n_groups > MAX_GROUPS:
        raise ValueError(f"{name}: {n_groups} groups exceed the kernel's "
                         f"{MAX_GROUPS}")
    _cuda.require_shape(f"{name} accept", accept, (feat.shape[0],))
    _cuda.require_shape(f"{name} boxes", boxes[0], (8, n_groups))
    _cuda.require_shape(f"{name} chunk boxes", boxes[-1],
                        (8, feat.shape[0] // CHUNK_ROWS))
    for what, t, shape in (("ro", ro, (R, 3)), ("rd", rd, (R, 3)),
                           ("t_lim", tl, (R,)), ("active", act, (R,)),
                           ("ray_id", rid, (R,))):
        _cuda.require_shape(f"{name} {what}", t, shape)
    n_tiles = -(-R // RAY_TILE)
    out_t = torch.empty(R, dtype=torch.float32, device=ro.device)
    out_p = torch.empty(R, dtype=torch.int32, device=ro.device)
    visits = torch.empty(n_tiles, dtype=torch.int32, device=ro.device)
    tests = torch.empty(n_tiles, dtype=torch.int32, device=ro.device)
    if R:
        lib = _cuda.lib()
        fn = lib.gi_trace_launch if kernel == "intersect" \
            else lib.gi_stream_launch
        sizes = (R, feat.shape[0]) if kernel == "intersect" \
            else (R, feat.shape[0], n_groups)
        code = fn(ro.data_ptr(), rd.data_ptr(), tl.data_ptr(), act.data_ptr(),
                  rid.data_ptr(), feat.data_ptr(), accept.data_ptr(),
                  *(b.data_ptr() for b in boxes), *sizes, int(salt) & M32,
                  float(eps), int(bool(any_hit)), int(bool(all_opaque)),
                  out_t.data_ptr(), out_p.data_ptr(), visits.data_ptr(),
                  tests.data_ptr(), _cuda.stream_ptr(ro.device))
        _cuda.check(code, f"{name} ({kernel} kernel)")
        _cuda.launches[kernel] += 1
    return (out_t, out_p, visits, tests) if return_counts else (out_t, out_p)


def walk_info(kernel: str, n_groups: int) -> dict:
    """The walk kernel's resources on the card at ``n_groups`` groups:
    resident blocks per SM, registers and local (spill) bytes per thread,
    dynamic and static shared bytes per block."""
    out = (ctypes.c_int * 5)()
    fn = _cuda.lib().gi_trace_info if kernel == "intersect" \
        else _cuda.lib().gi_stream_info
    _cuda.check(fn(int(n_groups), ctypes.addressof(out)), f"{kernel} info")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "dynamic_smem", "static_smem"), list(out)))
