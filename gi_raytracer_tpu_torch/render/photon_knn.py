"""kNN caustic estimate (K3): CUDA kernel wrapper + plain version.

Counterpart of ``gi_raytracer_tpu.render.photon_knn.sample_photons_tiled``.
Both compute the Jensen estimate of ``photon.sample_photons``: the query's
clamped 3x3x3 cell window (at most ``window_cap`` photons per cell, the
first in cell order), the k nearest photons, and
sum(col * dot(dir, qdir)) / (pi * r_k^2), divided by the window's
subsample rate got/true.  The kernel counts every photon with d^2 <= r_k^2
(ties included), as the TPU tile kernels do; the plain version takes
exactly the k nearest (lower window slot first on ties), as
``photon.sample_photons`` does.  They differ only on exact distance ties.

The TPU tile machinery (Morton tiles, the chunk table, tile classes, pass 2
and the chunk-row residual) is not ported: it exists for the TPU's layout.
The kernel answers each query with one warp (:func:`knn_info` reports its
resources on the card).
The render path runs under ``torch.no_grad()``; the kNN backward comes
with training, so the CUDA wrapper raises on inputs that need a gradient.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import _cuda
from .geom import PI

FAR = 1e29        # queries at or past this x are far sentinels (estimate 0)
KMAX = 64         # the kernel's k bound (csrc/knn.cu)


def _cells(pm, point):
    """Query cell coords: truncation toward zero, then clamp (int64)."""
    dims = torch.tensor(pm.dims, device=point.device)
    g = (point - pm.grid_min[None, :]) * pm.inv_cell[None, :]
    g = torch.clamp(g, -1.0, float(max(pm.dims)))
    return torch.minimum(torch.clamp(g.to(torch.int32), min=0),
                         dims - 1).long()


def _window(pm, gi):
    """Per-cell (start, end, dup) of the 27-cell window, in the reference's
    ox, oy, oz loop order."""
    nx, ny, nz = pm.dims
    out = []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                wx, wy, wz = gi[:, 0] + ox, gi[:, 1] + oy, gi[:, 2] + oz
                cx = torch.clamp(wx, 0, nx - 1)
                cy = torch.clamp(wy, 0, ny - 1)
                cz = torch.clamp(wz, 0, nz - 1)
                dup = (cx != wx) | (cy != wy) | (cz != wz)
                cid = (cx * ny + cy) * nz + cz
                out.append((pm.cell_start[cid].long(),
                            pm.cell_start[cid + 1].long(), dup))
    return out


def _block_estimate(pm, point, direction, k):
    """photon._sample_photons_block: (B, 3) estimates."""
    R = point.shape[0]
    cap = int(pm.window_cap)
    gi = _cells(pm, point)
    ar = torch.arange(cap, device=point.device)
    idx_l, ok_l = [], []
    n_true = torch.zeros(R, dtype=torch.int64, device=point.device)
    n_got = torch.zeros_like(n_true)
    for start, end, dup in _window(pm, gi):
        cnt = torch.where(dup, 0, end - start)
        n_true = n_true + cnt
        n_got = n_got + torch.clamp(cnt, max=cap)
        sl = start[:, None] + ar[None, :]
        idx_l.append(torch.clamp(sl, 0, pm.capacity - 1))
        ok_l.append((sl < end[:, None]) & ~dup[:, None])
    idx = torch.cat(idx_l, 1)
    ok = torch.cat(ok_l, 1)
    dp = pm.pos[idx] - point[:, None, :]
    # (dx*dx + dy*dy) + dz*dz, the kernel's order
    d2 = (dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1]) \
        + dp[..., 2] * dp[..., 2]
    d2 = torch.where(ok & pm.valid[idx], d2, torch.inf)
    kk = min(k, d2.shape[1])
    # a stable sort: among equal distances the lower candidate slot wins,
    # as in jax.lax.top_k
    top_d2, top_i = torch.sort(d2, dim=1, stable=True)
    top_d2, top_i = top_d2[:, :kk], top_i[:, :kk]
    found = torch.isfinite(top_d2)
    n_found = found.sum(1)
    sel = torch.gather(idx, 1, top_i)
    w = torch.sum(pm.dir[sel] * direction[:, None, :], -1)
    contrib = torch.where(found[:, :, None], pm.col[sel] * w[:, :, None], 0.0)
    total = contrib.sum(1)
    kth = torch.clamp(n_found - 1, 0, kk - 1)
    max_d2 = torch.gather(top_d2, 1, kth[:, None])[:, 0]
    has = n_found > 0
    denom = torch.where(has, PI * torch.clamp(max_d2, min=1e-20), 1.0)
    est = torch.where(has[:, None], total / denom[:, None], 0.0)
    dt = point.dtype
    p_rate = torch.where(n_true > 0,
                         n_got.to(dt) / torch.clamp(n_true, min=1).to(dt), 1.0)
    return est / torch.clamp(p_rate, min=1e-6)[:, None]


def sample_photons_plain(pm, point, direction, k, lane_chunk=None):
    """Port of ``photon.sample_photons`` (the per-point reference
    estimator).  Lanes whose window is empty, and far-sentinel lanes,
    return exactly 0 and are compacted out before the gather; the rest run
    in lane blocks that bound the (B, 27*cap) candidate intermediates."""
    _cuda.plain_calls["knn"] += 1
    R = point.shape[0]
    out = torch.zeros((R, 3), dtype=point.dtype, device=point.device)
    if R == 0:
        return out
    gi = _cells(pm, point)
    occ = torch.zeros(R, dtype=torch.int64, device=point.device)
    for start, end, _ in _window(pm, gi):
        occ = occ + (end - start)
    live = torch.nonzero((occ > 0) & (point[:, 0] < FAR)).squeeze(1)
    if lane_chunk is None:
        window = 27 * max(int(pm.window_cap), 1)
        lane_chunk = int(np.clip(2 ** int(np.log2(
            max(16_777_216 // window, 1024))), 1024, 32768))
    for s in range(0, live.shape[0], lane_chunk):
        ids = live[s:s + lane_chunk]
        out[ids] = _block_estimate(pm, point[ids], direction[ids], k)
    return out


def sample_photons_tiled(pm, point, direction, k):
    """The caustic estimate of the render path: on CPU tensors the plain
    version, on CUDA tensors the kNN kernel (``csrc/knn.cu``)."""
    if point.device.type == "cpu":
        return sample_photons_plain(pm, point, direction, k)
    return _knn_cuda(pm, point, direction, k)


def knn_info() -> dict:
    """The kNN kernel's resources on the card: resident blocks per SM,
    registers and local (spill) bytes per thread, dynamic and static shared
    bytes per block, threads per block, and the window candidates a warp
    keeps in registers."""
    out = (ctypes.c_int * 7)()
    _cuda.check(_cuda.lib().gi_knn_info(ctypes.addressof(out)), "gi_knn_info")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "dynamic_smem", "static_smem", "threads",
                     "register_candidates"), list(out)))


def _knn_tables(pm):
    """The map as the kernel reads it (float32 photons, uint8 valid flags,
    int32 cell ranges, the grid's origin and inverse cell size as Python
    floats), built once per PhotonMap object and kept on it: each render
    wave then launches the kernel without a conversion or a host sync."""
    tab = pm.__dict__.get("_knn_tables")
    if tab is None:
        tab = (pm.pos.float().contiguous(), pm.dir.float().contiguous(),
               pm.col.float().contiguous(),
               pm.valid.to(torch.uint8).contiguous(),
               pm.cell_start.to(torch.int32).contiguous(),
               [float(x) for x in pm.grid_min.tolist()],
               [float(x) for x in pm.inv_cell.tolist()])
        pm.__dict__["_knn_tables"] = tab
    return tab


def _knn_cuda(pm, point, direction, k):
    if point.requires_grad or pm.col.requires_grad or pm.pos.requires_grad:
        raise NotImplementedError(
            "the kNN kernel is forward-only; gradients through the caustic "
            "estimate wait for the kNN backward (ROADMAP A.6)")
    if not 1 <= k <= KMAX:
        raise ValueError(f"knn k={k} outside [1, {KMAX}]")
    R = point.shape[0]
    q = point.float().contiguous()
    qd = direction.float().contiguous()
    ppos, pdir, pcol, pval, cs, g, iv = _knn_tables(pm)
    _cuda.require_cuda("knn", q, qd, ppos, pdir, pcol, pval, cs)
    P = ppos.shape[0]
    nx, ny, nz = (int(x) for x in pm.dims)
    for what, t, shape in (("points", q, (R, 3)), ("directions", qd, (R, 3)),
                           ("photon dir", pdir, (P, 3)),
                           ("photon col", pcol, (P, 3)),
                           ("photon valid", pval, (P,)),
                           ("cell_start", cs, (nx * ny * nz + 1,))):
        _cuda.require_shape(f"knn {what}", t, shape)
    out = torch.empty((R, 3), dtype=torch.float32, device=q.device)
    if R == 0:
        return out.to(point.dtype)
    code = _cuda.lib().gi_knn_launch(
        q.data_ptr(), qd.data_ptr(), R, ppos.data_ptr(), pdir.data_ptr(),
        pcol.data_ptr(), pval.data_ptr(), cs.data_ptr(), nx, ny, nz,
        g[0], g[1], g[2], iv[0], iv[1], iv[2], int(pm.window_cap), int(k),
        out.data_ptr(), _cuda.stream_ptr(q.device))
    _cuda.check(code, "gi_knn_launch")
    _cuda.launches["knn"] += 1
    return out.to(point.dtype)
