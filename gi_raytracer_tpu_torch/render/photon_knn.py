"""kNN caustic estimate (K3): CUDA kernel wrapper + plain version.

Counterpart of ``gi_raytracer_tpu.render.photon_knn.sample_photons_tiled``,
the JAX package's accelerator estimate, whose TPU kernels
(``_tile_kernel_small/_large`` and ``_knn_kernel``) count every photon of
the query's window.  The estimator, for one query:

* window: the query's clamped 3x3x3 cell window (clamp duplicates
  skipped); every valid photon of those 27 cells is a candidate, with no
  per-cell cap;
* radius: r_k^2 is the k-th smallest d^2 when more than k candidates were
  found, else the largest d^2;
* estimate: sum(col * dot(dir, qdir)) / (pi * max(r_k^2, 1e-20)) over the
  candidates within r_k, and exactly 0 for an empty window or a far
  sentinel.

The kernel counts every candidate with d^2 <= r_k^2 (ties included), as
the TPU kernels do; the plain version (``sample_photons_plain``) takes
exactly the k nearest (lower window slot first on ties).  They differ only
on exact distance ties.  The JAX router sends a window past its VMEM
budgets (2,048 candidates a query in ``_fwd_perpoint``, a tile's chunk
rows in ``_fwd_impl``) to the capped per-point estimator; the port
computes the whole window for every query (ROADMAP C.6).

``sample_photons_capped`` is the port of ``photon.sample_photons``, the
JAX package's per-point estimator, which the ``"jnp"`` backend names: at
most ``window_cap`` photons a cell (the first in cell order), the k
nearest, divided by the window's subsample rate got/true.

The TPU tile machinery (Morton tiles, the chunk table, tile classes, pass 2
and the chunk-row residual) is not ported: it exists for the TPU's layout.
The kernel is two launches on one stream: a warp answers each query whose
window holds at most ``FOCAL`` candidates and queues the others, and a
persistent grid of blocks then answers the queued (focal) queries, a block
a query, with the window's distances staged once in shared memory
(:func:`knn_info` reports both tiers' resources on the card,
:func:`knn_counts` the last call's queue).

Gradients: ``sample_photons_tiled`` is a ``torch.autograd.Function``
whose forward is the kernel (the plain version on the CPU) and whose
backward is the vector-Jacobian product of the plain whole-window
estimator (``_block_estimate``) with respect to the query points and
directions and the map's photon positions, directions and colours,
recomputed block by block: the gradient of the port's own forward.  (The
JAX custom VJP differentiates its chunk-row path, which falls back to the
capped estimator past 96 chunk rows of 32 photons.)  The map's structure
(cells, order) and the k-nearest selection are detached.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import telemetry
from ..ops import _cuda
from ..scene.types import derived
from .geom import PI

FAR = 1e29        # queries at or past this x are far sentinels (estimate 0)
KMAX = 64         # the kernel's k bound (csrc/knn.cu)
# the warp tier's largest window (candidates a warp holds in registers,
# csrc/knn.cu GI_KNN_FOCAL): past it a query goes to the focal tier
FOCAL = 128
COUNTERS = 5      # int32 counters ahead of K3's queue (GI_KNN_COUNTERS)
# a plain block's bounds: lanes, and candidate slots (lanes times the
# block's largest window), which bound its (B, W) intermediates
BLOCK_LANES = 32_768
BLOCK_ENTRIES = 16_777_216


def _cells(pm, point):
    """Query cell coords: truncation toward zero, then clamp (int64)."""
    with telemetry.sync("knn.dims"):
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


def _window_takes(pm, point, cap=None):
    """(start, count, take), each (R, 27) int64 in the window's cell order:
    each cell's first photon, its photons (0 for a clamp duplicate) and
    the candidates the estimate takes from it: all (``cap=None``) or the
    first ``cap``."""
    win = _window(pm, _cells(pm, point))
    start = torch.stack([s for s, _, _ in win], 1)
    cnt = torch.stack([torch.where(d, 0, e - s) for s, e, d in win], 1)
    return start, cnt, (cnt if cap is None else torch.clamp(cnt, max=cap))


def _d2(dp):
    """(dx*dx + dy*dy) + dz*dz, the kernel's order."""
    return (dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1]) \
        + dp[..., 2] * dp[..., 2]


def _block_estimate(pm, point, direction, k, cap=None):
    """(B, 3) estimates of one block of lanes: the whole window
    (``cap=None``), or each cell's first ``cap`` photons divided by the
    window's subsample rate got/true (``photon._sample_photons_block``).
    A lane's candidates are its cells' takes laid end to end (window slot
    m lies in the first cell whose running take passes m), padded to the
    block's largest window and to at least k.  Every masked branch that
    can hold inf or NaN (the distance of an invalid slot, the photons of
    a slot past the k found, the radius of a lane that found none) is
    scrubbed before the arithmetic, so that a gradient never meets
    0 * inf; the estimate is the same."""
    R = point.shape[0]
    start, cnt, take = _window_takes(pm, point, cap)
    end = torch.cumsum(take, 1)
    n_got = end[:, -1]
    with telemetry.sync("knn.plain.width"):
        width = max(int(n_got.max()), k)
    m = torch.arange(width, device=point.device).expand(R, width) \
        .contiguous()
    cell = torch.clamp(torch.searchsorted(end, m, right=True), max=26)
    ok = m < n_got[:, None]
    # a slot past the window reads on past its lane's last cell: distinct
    # photons, masked out, not one photon that a backward would scatter
    # every padded slot's zero into
    idx = torch.clamp(
        torch.gather(start, 1, cell) + m - torch.gather(end - take, 1, cell),
        0, pm.capacity - 1)
    with torch.no_grad():
        # which k are nearest: detached, so that no (B, W) intermediate is
        # kept for a backward
        ok = ok & pm.valid[idx]
        dp = torch.where(ok[..., None], pm.pos[idx] - point[:, None, :], 0.0)
        d2 = torch.where(ok, _d2(dp), torch.inf)
        # a stable sort: among equal distances the lower candidate slot
        # wins, as in jax.lax.top_k
        top_d2, top_i = torch.sort(d2, dim=1, stable=True)
        found = torch.isfinite(top_d2[:, :k])
    n_found = found.sum(1)
    sel = torch.gather(idx, 1, top_i[:, :k])
    fs = found[:, :, None]
    # the k nearest again, under autograd: the estimate depends on the
    # photon positions and the point only through r_k^2
    top_d2 = _d2(torch.where(fs, pm.pos[sel] - point[:, None, :], 0.0))
    w = torch.sum(torch.where(fs, pm.dir[sel], 0.0) * direction[:, None, :],
                  -1)
    contrib = torch.where(fs, pm.col[sel], 0.0) * w[:, :, None]
    total = contrib.sum(1)
    kth = torch.clamp(n_found - 1, 0, k - 1)
    has = n_found > 0
    max_d2 = torch.where(has, torch.gather(top_d2, 1, kth[:, None])[:, 0],
                         1.0)
    denom = torch.where(has, PI * torch.clamp(max_d2, min=1e-20), 1.0)
    est = torch.where(has[:, None], total / denom[:, None], 0.0)
    if cap is None:
        return est
    dt = point.dtype
    n_true = cnt.sum(1)
    p_rate = torch.where(n_true > 0,
                         n_got.to(dt) / torch.clamp(n_true, min=1).to(dt), 1.0)
    return est / torch.clamp(p_rate, min=1e-6)[:, None]


def _plain_blocks(pm, point, k, cap=None, lane_chunk=None):
    """The lanes a plain estimate computes, as a list of index blocks.
    Lanes whose window is empty, and far-sentinel lanes, estimate exactly
    0 and are left out; the rest, sorted by window size, fill blocks of at
    most ``lane_chunk`` (default BLOCK_LANES) lanes and BLOCK_ENTRIES
    candidate slots, so that one focal window pads no block of small
    ones."""
    n = _window_takes(pm, point, cap)[2].sum(1)
    with telemetry.sync("knn.plain.live"):
        live = torch.nonzero((n > 0) & (point[:, 0] < FAR)).squeeze(1)
    n, order = torch.sort(n[live], stable=True)
    live = live[order]
    with telemetry.sync("knn.plain.widths"):
        width = np.maximum(n.cpu().numpy(), k)
    lanes = lane_chunk or BLOCK_LANES
    blocks, s = [], 0
    while s < width.shape[0]:
        w = width[s:s + lanes]
        # w ascends, so a block of b lanes holds b * w[b - 1] slots
        fit = np.searchsorted(np.arange(1, w.shape[0] + 1) * w,
                              BLOCK_ENTRIES, side="right")
        blocks.append(live[s:s + max(int(fit), 1)])
        s += blocks[-1].shape[0]
    return blocks


def _plain_estimate(pm, point, direction, k, cap, lane_chunk):
    out = torch.zeros((point.shape[0], 3), dtype=point.dtype,
                      device=point.device)
    if point.shape[0] == 0:
        return out
    for ids in _plain_blocks(pm, point, k, cap, lane_chunk):
        out[ids] = _block_estimate(pm, point[ids], direction[ids], k, cap)
    return out


def sample_photons_plain(pm, point, direction, k, lane_chunk=None):
    """The plain version of K3: the whole-window estimate of the TPU kNN
    kernels in torch, block by block (``_plain_blocks``)."""
    _cuda.plain_calls["knn"] += 1
    return _plain_estimate(pm, point, direction, k, None, lane_chunk)


def sample_photons_capped(pm, point, direction, k, lane_chunk=None):
    """Port of ``photon.sample_photons``, the JAX package's per-point
    estimator (``knn_backend="jnp"``): at most ``pm.window_cap`` photons a
    window cell, divided by the window's subsample rate got/true.  Plain
    torch on any device."""
    _cuda.plain_calls["knn"] += 1
    return _plain_estimate(pm, point, direction, k, int(pm.window_cap),
                           lane_chunk)


def _estimate_vjp(pm, k, point, direction, grad, need):
    """The VJP of the plain whole-window estimator: the gradients of
    ``sum(grad * estimate)`` with respect to (point, direction, pm.pos,
    pm.dir, pm.col), each None where ``need`` says so.  It recomputes
    ``_block_estimate`` block by block (``_plain_blocks``) under grad mode
    and sums the blocks' photon gradients, so at most one block's
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
    with torch.enable_grad():
        for ids in _plain_blocks(pm, point, k):
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
        with telemetry.span("knn.vjp", queries=point.shape[0]):
            grads = _estimate_vjp(ctx.pm, ctx.k, point, direction, grad,
                                 ctx.needs_input_grad[2:])
        return (None, None, *grads)


def sample_photons_tiled(pm, point, direction, k):
    """The caustic estimate of the render path, over the whole window: on
    CPU tensors the plain version, on CUDA tensors the kNN kernel
    (``csrc/knn.cu``), which raises rather than fall back; gradients
    flow to ``point``, ``direction`` and the map's ``pos``, ``dir`` and
    ``col`` through the plain estimator's VJP.  Where no gradient is
    wanted (the render path runs under ``torch.no_grad()``) the forward
    runs without the Function, whose bookkeeping costs about as much host
    time as the kernel takes on the card."""
    ts = (point, direction, pm.pos, pm.dir, pm.col)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return _KnnEstimate.apply(pm, k, *ts)
    return _estimate(pm, point, direction, k)


_RESOURCES = ("blocks_per_sm", "registers", "local_bytes", "dynamic_smem",
              "static_smem", "threads")


def knn_info() -> dict:
    """Both tiers' resources on the card: ``"warp"`` and ``"focal"`` each
    give resident blocks per SM, registers and local (spill) bytes per
    thread, dynamic and static shared bytes per block and threads per
    block; the warp tier also the window candidates a warp keeps in
    registers, the focal tier its grid.  ``focal_threshold`` is the warp
    tier's largest window (``FOCAL``), ``staged_capacity`` the candidates a
    focal block stages in shared memory, ``counters`` the int32 counts a
    launch takes."""
    out = (ctypes.c_int * 16)()
    _cuda.check(_cuda.lib().gi_knn_info(ctypes.addressof(out)),
                "gi_knn_info")
    v = list(out)
    return {"focal_threshold": v[6], "staged_capacity": v[14],
            "counters": v[15],
            "warp": dict(zip(_RESOURCES, v[:6]), register_candidates=v[6]),
            "focal": dict(zip(_RESOURCES, v[7:13]), grid=v[13])}


def knn_counts(pm) -> tuple:
    """(queries queued for the focal tier, queue entries the focal blocks
    took) by the last K3 call on ``pm`` (a host sync; 0, 0 before one).
    ``telemetry.k3_counts`` sums them over the calls made while
    recording, with no sync."""
    scratch = pm.__dict__.get("_knn_scratch")
    if scratch is None:
        return 0, 0
    with telemetry.sync("knn.counts"):
        return tuple(scratch[3:5].tolist())


def _knn_scratch(pm, n_q, device):
    """The counters K3 takes, then its queue (at least n_q int32), kept on the
    PhotonMap and grown with the largest call: the counters are zeroed
    once here and by each launch's last focal block after, so a call
    allocates and clears nothing.  K3 calls on one map run in turn, on
    one stream."""
    kept = pm.__dict__.get("_knn_scratch")
    if kept is None or kept.device != device or \
            kept.shape[0] < COUNTERS + n_q:
        kept = torch.zeros(COUNTERS + n_q, dtype=torch.int32, device=device)
        pm.__dict__["_knn_scratch"] = kept
    return kept


def _knn_tables(pm):
    """The map as the kernel reads it (float32 photons, uint8 valid flags,
    int32 cell ranges, the grid's origin and inverse cell size as Python
    floats), kept on the PhotonMap object and built again after its
    tensors change (``types.derived``): each render wave then launches the
    kernel without a conversion, a host sync or the tables' checks, which
    are made here once."""
    def build():
        t = (pm.pos.detach().float().contiguous(),
             pm.dir.detach().float().contiguous(),
             pm.col.detach().float().contiguous(),
             pm.valid.to(torch.uint8).contiguous(),
             pm.cell_start.to(torch.int32).contiguous())
        P = t[0].shape[0]
        for what, x, shape in (("photon pos", t[0], (P, 3)),
                               ("photon dir", t[1], (P, 3)),
                               ("photon col", t[2], (P, 3)),
                               ("photon valid", t[3], (P,))):
            _cuda.require_shape(f"knn {what}", x, shape)
        if any(x.device != t[0].device for x in t):
            raise ValueError("knn: the photon map's tensors lie on more "
                             "than one device")
        with telemetry.sync("knn.tables.origin"):
            g = [float(x) for x in pm.grid_min.tolist()]
        with telemetry.sync("knn.tables.scale"):
            return t + (g, [float(x) for x in pm.inv_cell.tolist()])

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
    _cuda.require_cuda("knn", q, qd, ppos)
    nx, ny, nz = (int(x) for x in pm.dims)
    for what, t, shape in (("points", q, (R, 3)), ("directions", qd, (R, 3)),
                           ("cell_start", cs, (nx * ny * nz + 1,))):
        _cuda.require_shape(f"knn {what}", t, shape)
    out = torch.empty((R, 3), dtype=torch.float32, device=q.device)
    if R == 0:
        return out.to(point.dtype)
    scratch = _knn_scratch(pm, R, q.device).data_ptr()
    with telemetry.span("knn", queries=R) as sp:
        # while recording, the launch adds its tier counts to the totals
        code = _cuda.lib().gi_knn_launch(
            q.data_ptr(), qd.data_ptr(), R, ppos.data_ptr(), pdir.data_ptr(),
            pcol.data_ptr(), pval.data_ptr(), cs.data_ptr(), nx, ny, nz,
            g[0], g[1], g[2], iv[0], iv[1], iv[2], int(k),
            scratch + 4 * COUNTERS, scratch,
            telemetry.k3_totals_ptr() if sp is not None else None,
            out.data_ptr(), _cuda.stream_ptr(q.device))
    _cuda.check(code, "gi_knn_launch")
    _cuda.launches["knn"] += 1
    return out.to(point.dtype)
