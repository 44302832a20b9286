"""Host-side flat BVH builder with preorder skip links.

Counterpart of ``gi_raytracer_tpu.scene.bvh``: node i descends to i+1 on
AABB hit and jumps to skip[i] on miss / after a leaf; skip[last] == n_nodes
terminates.  The scene builder uses the leaf order to permute triangles so
that consecutive triangles are spatially coherent.  The default is the
native binned-SAH builder (``gi_raytracer_tpu_torch.native``), as in the
JAX package; ``use_native=False`` takes the numpy median split, which
orders the triangles differently.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np


@dataclasses.dataclass
class BVHArrays:
    node_min: np.ndarray   # (N, 3) float
    node_max: np.ndarray   # (N, 3) float
    skip: np.ndarray       # (N,) int32
    first: np.ndarray      # (N,) int32
    count: np.ndarray      # (N,) int32 (0 => inner node)
    prim_idx: np.ndarray   # (P,) int32


def build_bvh(pmin: np.ndarray, pmax: np.ndarray, leaf_size: int = 4,
              use_native: bool = True) -> BVHArrays:
    """BVH over per-primitive AABBs (pmin/pmax: (P, 3)): the native SAH
    build by default (it raises when the library cannot be built), the
    numpy median split with ``use_native=False`` or for no primitives."""
    if use_native and len(pmin) > 0:
        from ..native import build_bvh_native
        try:
            return build_bvh_native(np.asarray(pmin), np.asarray(pmax),
                                    leaf_size)
        except (OSError, RuntimeError) as e:
            raise RuntimeError(
                f"the native SAH BVH builder is unavailable ({e}); pass "
                "use_native=False for the numpy median split (another "
                "triangle order)") from e
    return _build_bvh_numpy(pmin, pmax, leaf_size)


def _build_bvh_numpy(pmin: np.ndarray, pmax: np.ndarray,
                     leaf_size: int = 4) -> BVHArrays:
    """Median-split BVH over the longest centroid axis."""
    P = len(pmin)
    if P == 0:
        return BVHArrays(np.zeros((1, 3), np.float64),
                         np.zeros((1, 3), np.float64),
                         np.array([1], np.int32), np.array([0], np.int32),
                         np.array([0], np.int32), np.zeros(0, np.int32))

    centers = (pmin + pmax) * 0.5
    node_min, node_max, first, count = [], [], [], []
    children = []            # per node: (left, right) or None
    order = []               # final primitive order

    def emit(idx: np.ndarray) -> int:
        nid = len(node_min)
        node_min.append(pmin[idx].min(0))
        node_max.append(pmax[idx].max(0))
        if len(idx) <= leaf_size:
            first.append(len(order))
            count.append(len(idx))
            order.extend(idx.tolist())
            children.append(None)
            return nid
        first.append(0)
        count.append(0)
        children.append(None)  # patched below
        c = centers[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        srt = idx[np.argsort(c[:, axis], kind="stable")]
        half = len(srt) // 2
        left = emit(srt[:half])
        right = emit(srt[half:])
        children[nid] = (left, right)
        return nid

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * int(np.log2(P + 1) + 64)))
    try:
        emit(np.arange(P))
    finally:
        sys.setrecursionlimit(old_limit)

    n = len(node_min)
    skip = np.full(n, n, np.int32)
    stack = [(0, n)]
    while stack:
        nid, escape = stack.pop()
        skip[nid] = escape
        ch = children[nid]
        if ch is not None:
            left, right = ch
            stack.append((left, right))
            stack.append((right, escape))

    return BVHArrays(np.asarray(node_min), np.asarray(node_max),
                     skip.astype(np.int32),
                     np.asarray(first, np.int32), np.asarray(count, np.int32),
                     np.asarray(order, np.int32))
