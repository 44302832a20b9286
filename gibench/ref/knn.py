"""Frozen copy of the plain whole-window caustic estimate of
``gi_raytracer_tpu_torch/render/photon_knn.py`` (``_cells`` through
``sample_photons_plain``) at commit
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0, without the kernel, the capped
estimator and the counters.

The estimator, for one query: every valid photon of the query's clamped
3x3x3 cell window is a candidate; r_k^2 is the k-th smallest d^2 when more
than k candidates were found, else the largest; the estimate is
sum(col * dot(dir, qdir)) / (pi * max(r_k^2, 1e-20)) over the k nearest,
and exactly 0 for an empty window or a far sentinel.  It is plain torch,
so autograd differentiates it (the selection is detached).
"""

from __future__ import annotations

import numpy as np
import torch

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
    live = torch.nonzero((n > 0) & (point[:, 0] < FAR)).squeeze(1)
    n, order = torch.sort(n[live], stable=True)
    live = live[order]
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
    return _plain_estimate(pm, point, direction, k, None, lane_chunk)
