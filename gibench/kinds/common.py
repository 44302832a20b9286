"""What the kinds of entry share: the program's and the reference's
scene, configuration and camera from a cell, and the comparisons of
photon batches."""

from __future__ import annotations

import numpy as np
import torch

from ..core import scene as sc

# a stored photon is off when its position is off by more than this
# (world units; the scenes span 8 and 40)
PHOTON_POS_TOL = 1e-3


def render_config(cls, traffic: dict, seed: int, **over):
    """A ``RenderConfig`` (the program's or the reference's class) of the
    traffic: fixed spp, its depth, k, photon slots and chunk."""
    spp = int(traffic.get("spp", 1))
    kw = dict(min_samples=spp, max_samples=spp, adaptive=False,
              max_depth=int(traffic["depth"]),
              photons=int(traffic.get("photons", 0)) or 75_000,
              knn_k=int(traffic.get("knn_k", 32)),
              ray_chunk=int(traffic.get("ray_chunk", 1 << 17)),
              seed=int(seed))
    kw.update(over)
    return cls(**kw)


def program_scene(run):
    """The cell's scene through the program's ``SceneBuilder`` (its SAH
    build and the nvcc build of its kernels first), timed as
    ``scene_build``."""
    from gi_raytracer_tpu_torch.ops import _cuda
    from gi_raytracer_tpu_torch.scene import SceneBuilder
    if run.device.type == "cuda":
        _cuda.build()
        _cuda.lib()
    with run.span("scene_build"):
        scene = sc.populate(SceneBuilder, run.cell.config).build(
            device=run.device)
    want = run.cell.config.get("triangles")
    if want is not None and scene.n_tris != want:
        raise ValueError(f"the scene has {scene.n_tris} triangles, its "
                         f"configuration {want}")
    return scene


def program_camera(run):
    from gi_raytracer_tpu_torch.render import Camera
    pos, at = sc.camera(run.cell.config, run.seed)
    return Camera(pos=pos, look_at=at)


def ref_scene(run):
    from ..ref.build import SceneBuilder
    return sc.populate(SceneBuilder, run.cell.config).build(
        device=run.device)


def ref_camera(run):
    from ..ref.camera import Camera
    pos, at = sc.camera(run.cell.config, run.seed)
    return Camera(pos=pos, look_at=at)


def in_slot_order(x, order):
    """A photon map's per-photon tensor ``x`` in slot order (the map's
    ``order`` sends slot i to sorted place i's photon)."""
    out = torch.empty_like(x)
    out[order.long()] = x
    return out


def batch_of_map(pm):
    """(pos, stored) of a photon map, in slot order."""
    return in_slot_order(pm.pos, pm.order), in_slot_order(pm.valid, pm.order)


def photon_off(pos, stored, ref_pos, ref_stored) -> float:
    """Share of the slots whose stored flag differs from the reference's,
    or whose stored position is off by more than ``PHOTON_POS_TOL``."""
    far = (pos - ref_pos).abs().amax(-1) > PHOTON_POS_TOL
    off = (stored != ref_stored) | (stored & ref_stored & far)
    return float(off.float().mean())


def draw(seed: int, n: int, k: int, salt: int) -> np.ndarray:
    """``k`` distinct indices below ``n``, drawn from the seed."""
    g = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, salt])
    return np.sort(g.choice(n, size=min(k, n), replace=False))
