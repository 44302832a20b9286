"""The work of the caustic estimate (K3) on a set of queries: a frozen
copy of ``chip_smoke.k3_bytes`` at commit
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0, on the reference's frozen copy
of the window helpers (``ref/knn.py``) instead of the program's, plus
the operations of the estimator's 27-cell windows.

Bytes: each query's point and direction read (24) and its estimate
written (12); for the queries short of the far sentinel, each distinct
``cell_start`` entry of their windows (4), the position and valid flag of
each distinct photon in those cells (13), and the direction and colour of
each distinct photon within some query's r_k (24).  Operations: a d^2
(``peaks.OPS_PER_CANDIDATE``) for every candidate of every query's
window.  What these queries need, whatever kernel answers them.
"""

from __future__ import annotations

import torch

from ..ref.knn import FAR, _cells, _d2, _plain_blocks, _window_takes
from .peaks import OPS_PER_CANDIDATE


@torch.no_grad()
def k3_work(pm, pts, k) -> tuple:
    """(operations, bytes, parts) of one estimate over queries ``pts``
    on map ``pm`` (any object with the photon map's fields)."""
    near = pts[:, 0] < FAR
    nx, ny, nz = pm.dims
    gi = _cells(pm, pts[near])
    cids = []
    dims = torch.tensor(pm.dims, device=pts.device)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                w = gi + torch.tensor([ox, oy, oz], device=pts.device)
                inside = ((w >= 0) & (w < dims)).all(1)
                w = w[inside]
                cids.append((w[:, 0] * ny + w[:, 1]) * nz + w[:, 2])
    cells = torch.unique(torch.cat(cids))
    entries = torch.unique(torch.cat([cells, cells + 1])).numel()
    photons = int((pm.cell_start[cells + 1].long()
                   - pm.cell_start[cells].long()).sum())
    candidates = int(_window_takes(pm, pts[near])[2].sum())
    within = torch.zeros(pm.capacity, dtype=torch.bool, device=pts.device)
    for ids in _plain_blocks(pm, pts, k):
        start, _, take = _window_takes(pm, pts[ids])
        end = torch.cumsum(take, 1)
        n_got = end[:, -1]
        m = torch.arange(int(n_got.max()), device=pts.device) \
            .expand(ids.shape[0], -1).contiguous()
        cell = torch.clamp(torch.searchsorted(end, m, right=True), max=26)
        idx = torch.clamp(torch.gather(start, 1, cell) + m
                          - torch.gather(end - take, 1, cell),
                          0, pm.capacity - 1)
        ok = (m < n_got[:, None]) & pm.valid[idx]
        d2 = torch.where(ok, _d2(pm.pos[idx] - pts[ids][:, None, :]),
                         torch.inf)
        rank = torch.clamp(ok.sum(1), 1, k)
        rk2 = torch.gather(torch.sort(d2, 1).values, 1, rank[:, None] - 1)
        within[idx[ok & (d2 <= rk2)]] = True
    parts = dict(queries=pts.shape[0], cell_start_entries=entries,
                 window_photons=photons, candidates=candidates,
                 photons_within_rk=int(within.sum()))
    nbytes = (pts.shape[0] * (24 + 12) + entries * 4 + photons * 13
              + parts["photons_within_rk"] * 24)
    return candidates * OPS_PER_CANDIDATE, nbytes, parts
