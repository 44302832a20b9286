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

Gradients: ``sample_photons_tiled`` is a ``torch.autograd.Function``
whose forward is the kernel (the plain version on the CPU) and whose
backward is the vector-Jacobian product of the plain estimator
(``_block_estimate``) with respect to the query points and directions and
the map's photon positions, directions and colours, recomputed lane chunk
by lane chunk: the counterpart of the JAX custom VJP
(``photon_knn._make_tiled_fn``), which differentiates a plain jnp
estimator and reaches no TPU kernel.  The map's structure (cells, order,
window cap) and the k-nearest selection are detached.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..ops import _cuda
from ..scene.types import derived
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
    """photon._sample_photons_block: (B, 3) estimates.  Every masked
    branch that can hold inf or NaN (the distance of an invalid slot, the
    photons of a slot past the k found, the radius of a lane that found
    none) is scrubbed before the arithmetic, so that a gradient never
    meets 0 * inf; the estimate is the same."""
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
    ok = torch.cat(ok_l, 1) & pm.valid[idx]
    dp = torch.where(ok[..., None], pm.pos[idx] - point[:, None, :], 0.0)
    # (dx*dx + dy*dy) + dz*dz, the kernel's order
    d2 = (dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1]) \
        + dp[..., 2] * dp[..., 2]
    d2 = torch.where(ok, d2, torch.inf)
    kk = min(k, d2.shape[1])
    # a stable sort: among equal distances the lower candidate slot wins,
    # as in jax.lax.top_k
    top_d2, top_i = torch.sort(d2, dim=1, stable=True)
    top_d2, top_i = top_d2[:, :kk], top_i[:, :kk]
    found = torch.isfinite(top_d2)
    n_found = found.sum(1)
    sel = torch.gather(idx, 1, top_i)
    fs = found[:, :, None]
    w = torch.sum(torch.where(fs, pm.dir[sel], 0.0) * direction[:, None, :],
                  -1)
    contrib = torch.where(fs, pm.col[sel], 0.0) * w[:, :, None]
    total = contrib.sum(1)
    kth = torch.clamp(n_found - 1, 0, kk - 1)
    has = n_found > 0
    max_d2 = torch.where(has, torch.gather(top_d2, 1, kth[:, None])[:, 0],
                         1.0)
    denom = torch.where(has, PI * torch.clamp(max_d2, min=1e-20), 1.0)
    est = torch.where(has[:, None], total / denom[:, None], 0.0)
    dt = point.dtype
    p_rate = torch.where(n_true > 0,
                         n_got.to(dt) / torch.clamp(n_true, min=1).to(dt), 1.0)
    return est / torch.clamp(p_rate, min=1e-6)[:, None]


def _live_lanes(pm, point):
    """Lanes whose window holds a photon and that are no far sentinel (the
    others' estimate is exactly 0)."""
    gi = _cells(pm, point)
    occ = torch.zeros(point.shape[0], dtype=torch.int64, device=point.device)
    for start, end, _ in _window(pm, gi):
        occ = occ + (end - start)
    return torch.nonzero((occ > 0) & (point[:, 0] < FAR)).squeeze(1)


def _lane_chunk(pm) -> int:
    """Lanes per block: bounds the (B, 27*cap) candidate intermediates to
    about 16M entries."""
    window = 27 * max(int(pm.window_cap), 1)
    return int(np.clip(2 ** int(np.log2(max(16_777_216 // window, 1024))),
                       1024, 32768))


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
    live = _live_lanes(pm, point)
    lane_chunk = lane_chunk or _lane_chunk(pm)
    for s in range(0, live.shape[0], lane_chunk):
        ids = live[s:s + lane_chunk]
        out[ids] = _block_estimate(pm, point[ids], direction[ids], k)
    return out


def _estimate_vjp(pm, k, point, direction, grad, need):
    """The VJP of the plain estimator: the gradients of
    ``sum(grad * estimate)`` with respect to (point, direction, pm.pos,
    pm.dir, pm.col), each None where ``need`` says so.  It recomputes
    ``_block_estimate`` lane chunk by lane chunk under grad mode and sums
    the chunks' photon gradients, so at most one chunk's (B, 27*cap)
    intermediates are alive; lanes the forward leaves at 0 (empty window,
    far sentinel) get a zero gradient."""
    R = point.shape[0]
    g_pt = torch.zeros_like(point) if need[0] else None
    g_dir = torch.zeros_like(direction) if need[1] else None
    photons = [t.detach().requires_grad_(n)
               for t, n in zip((pm.pos, pm.dir, pm.col), need[2:])]
    g_ph = [torch.zeros_like(t) if n else None
            for t, n in zip(photons, need[2:])]
    if R == 0 or not any(need):
        return (g_pt, g_dir, *g_ph)
    pm_d = dataclasses.replace(pm, pos=photons[0], dir=photons[1],
                               col=photons[2])
    live = _live_lanes(pm, point)
    B = _lane_chunk(pm)
    with torch.enable_grad():
        for s in range(0, live.shape[0], B):
            ids = live[s:s + B]
            p = point[ids].detach().requires_grad_(need[0])
            d = direction[ids].detach().requires_grad_(need[1])
            est = _block_estimate(pm_d, p, d, k)
            wrt = [x for x, n in zip((p, d, *photons), need) if n]
            got = iter(torch.autograd.grad(est, wrt, grad[ids]))
            if need[0]:
                g_pt[ids] = next(got)
            if need[1]:
                g_dir[ids] = next(got)
            for i in range(3):
                if need[2 + i]:
                    g_ph[i] += next(got)
    return (g_pt, g_dir, *g_ph)


def _estimate(pm, point, direction, k):
    """The forward: the kNN kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if point.device.type == "cpu":
        return sample_photons_plain(pm, point, direction, k)
    return _knn_cuda(pm, point, direction, k)


class _KnnEstimate(torch.autograd.Function):
    """The caustic estimate with a backward: forward :func:`_estimate`,
    backward :func:`_estimate_vjp`.  The photon tensors are passed beside
    the map so that autograd sees them; only the inputs are saved."""

    @staticmethod
    def forward(ctx, pm, k, point, direction, pos, pdir, pcol):
        ctx.pm, ctx.k = pm, k
        ctx.save_for_backward(point, direction)
        return _estimate(pm, point, direction, k)

    @staticmethod
    def backward(ctx, grad):
        point, direction = ctx.saved_tensors
        grads = _estimate_vjp(ctx.pm, ctx.k, point, direction, grad,
                             ctx.needs_input_grad[2:])
        return (None, None, *grads)


def sample_photons_tiled(pm, point, direction, k):
    """The caustic estimate of the render path: on CPU tensors the plain
    version, on CUDA tensors the kNN kernel (``csrc/knn.cu``); gradients
    flow to ``point``, ``direction`` and the map's ``pos``, ``dir`` and
    ``col`` through the plain estimator's VJP.  Where no gradient is
    wanted (the render path runs under ``torch.no_grad()``) the forward
    runs without the Function, whose bookkeeping costs about as much host
    time as the kernel takes on the card."""
    ts = (point, direction, pm.pos, pm.dir, pm.col)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return _KnnEstimate.apply(pm, k, *ts)
    return _estimate(pm, point, direction, k)


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
    floats), kept on the PhotonMap object and built again after its
    tensors change (``types.derived``): each render wave then launches the
    kernel without a conversion or a host sync."""
    def build():
        return (pm.pos.detach().float().contiguous(),
                pm.dir.detach().float().contiguous(),
                pm.col.detach().float().contiguous(),
                pm.valid.to(torch.uint8).contiguous(),
                pm.cell_start.to(torch.int32).contiguous(),
                [float(x) for x in pm.grid_min.tolist()],
                [float(x) for x in pm.inv_cell.tolist()])

    return derived(pm, "_knn_tables", (pm.pos, pm.dir, pm.col, pm.valid,
                                       pm.cell_start, pm.grid_min,
                                       pm.inv_cell), build)


def _knn_cuda(pm, point, direction, k):
    if not 1 <= k <= KMAX:
        raise ValueError(f"knn k={k} outside [1, {KMAX}]")
    R = point.shape[0]
    q = point.detach().float().contiguous()
    qd = direction.detach().float().contiguous()
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
