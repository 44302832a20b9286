"""The dense triangle trace (K2): CUDA kernel wrapper + plain version.

Counterpart of ``gi_raytracer_tpu.ops.pallas_intersect`` (``_kernel`` via
``_dense_trace``/``pallas_prim_query``).  The query: for each ray, the
accepted triangle with the smallest approximate t below the ray's t limit
(ties to the smallest prim id), or with ``any_hit`` the first accepted
triangle in index order.  The accept test is the separable, homogeneous
Moller-Trumbore form of the TPU kernel on per-triangle features
(n2 = e1 x e2, fu = v0 x e2, fv = v0 x e1, d0 = v0 . n2, e1, e2), with the
stochastic-alpha hash keyed on the caller's ray ids unless the scene is
``all_opaque``.  The exact (t, u, v) of the winner is recomputed in torch
(:func:`exact_hit`), so gradients reach the vertices by ordinary autograd.

``prim_query`` is the wrapper: on CPU tensors it runs
:func:`prim_query_plain`; on CUDA tensors it launches
``csrc/intersect.cu`` or raises.
"""

from __future__ import annotations

import torch

from ..sampling.rng import bits_to_u01, mul32, _mix, M32
from . import _cuda

BIG = 3.0e38
FEAT_W = 16
TRI_PAD = 128          # feature tables are padded to a multiple of this
_PLAIN_BLOCK = 1 << 22   # ray x triangle pairs per plain-version block


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


def prim_query_plain(feat, accept, ro, rd, t_lim, active, ray_id, salt,
                     eps=1e-5, any_hit=False, all_opaque=False):
    """Brute-force plain version of the trace kernel: every ray against
    every triangle, in blocks, with the kernel's accept test and tie rule.
    Returns (t_approx (R,) f32 (BIG on miss), prim (R,) int32)."""
    _cuda.plain_calls["intersect"] += 1
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


def prim_query(feat, accept, ro, rd, t_lim, active, ray_id, salt,
               eps=1e-5, any_hit=False, all_opaque=False):
    """(t_approx (R,), prim (R,)) for the winning triangle per ray (-1 =
    miss).  ``t_lim`` (R,) f32, ``active`` (R,) bool, ``ray_id`` (R,) ints
    keying the alpha stream, ``salt`` a uint32 int."""
    if ro.device.type == "cpu":
        return prim_query_plain(feat, accept, ro, rd, t_lim, active, ray_id,
                                salt, eps, any_hit, all_opaque)
    return _prim_query_cuda(feat, accept, ro, rd, t_lim, active, ray_id,
                            salt, eps, any_hit, all_opaque)


def _prim_query_cuda(feat, accept, ro, rd, t_lim, active, ray_id, salt,
                     eps, any_hit, all_opaque):
    R = ro.shape[0]
    ro = ro.float().contiguous()
    rd = rd.float().contiguous()
    tl = t_lim.float().contiguous()
    act = active.to(torch.uint8).contiguous()
    rid = (ray_id.to(torch.int64) & M32).to(torch.int32).contiguous() \
        if ray_id.dtype != torch.int32 else ray_id.contiguous()
    _cuda.require_cuda("prim_query", feat, accept, ro, rd, tl, act, rid)
    if (feat.dim() != 2 or feat.shape[1] != FEAT_W
            or feat.shape[0] % TRI_PAD or feat.dtype != torch.float32
            or accept.dtype != torch.float32):
        raise ValueError(f"prim_query: feature table {tuple(feat.shape)} "
                         f"{feat.dtype}, accept {accept.dtype}")
    _cuda.require_shape("prim_query accept", accept, (feat.shape[0],))
    for what, t, shape in (("ro", ro, (R, 3)), ("rd", rd, (R, 3)),
                           ("t_lim", tl, (R,)), ("active", act, (R,)),
                           ("ray_id", rid, (R,))):
        _cuda.require_shape(f"prim_query {what}", t, shape)
    out_t = torch.empty(R, dtype=torch.float32, device=ro.device)
    out_p = torch.empty(R, dtype=torch.int32, device=ro.device)
    if R == 0:
        return out_t, out_p
    lib = _cuda.lib()
    code = lib.gi_trace_launch(
        ro.data_ptr(), rd.data_ptr(), tl.data_ptr(), act.data_ptr(),
        rid.data_ptr(), feat.data_ptr(), accept.data_ptr(), R,
        feat.shape[0], int(salt) & M32, float(eps), int(bool(any_hit)),
        int(bool(all_opaque)), out_t.data_ptr(), out_p.data_ptr(),
        _cuda.stream_ptr(ro.device))
    _cuda.check(code, "gi_trace_launch")
    _cuda.launches["intersect"] += 1
    return out_t, out_p
