"""Carry scenes, photon batches, photon maps and configs across from numpy.

The parity tests turn a JAX ``Scene``/``PhotonBatch``/``PhotonMap`` into
numpy arrays (plus its static fields) and feed them here, so both packages
compute on identical triangle order and identical photons.  Array keys are
the port's field paths: ``"tris.v0"``, ``"lights.pos"``, ``"world_min"``...
``cones.*`` and ``fog.*`` keys are present only when the scene has them.
Like every entry point of the port, they put their tensors on the card
unless the caller passes ``device="cpu"``, and raise when there is none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import RenderConfig
from .ops._cuda import resolve_device
from .render.photon import PhotonBatch, PhotonMap
from .scene import types as T


def _tensor(x, device, float_dtype=torch.float32):
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int32)).to(device)
    return torch.from_numpy(a.astype(np.float64)).to(device=device,
                                                      dtype=float_dtype)


def scene_from_arrays(arrays: dict, *, all_opaque: bool,
                      has_image_tex: bool = False, leaf_size: int = 4,
                      device="cuda", dtype=torch.float32) -> T.Scene:
    """A port ``Scene`` from ``{"tris.v0": ..., ...}`` numpy arrays."""
    dev = resolve_device(device)

    def group(prefix, cls, **extra):
        kw = {f.name: _tensor(arrays[f"{prefix}.{f.name}"], dev, dtype)
              for f in dataclasses.fields(cls) if f.name not in extra}
        kw.update(extra)
        return cls(**kw)

    def optional(prefix, cls):
        first = dataclasses.fields(cls)[0].name
        return group(prefix, cls) if f"{prefix}.{first}" in arrays else None

    return T.Scene(
        tris=group("tris", T.Triangles),
        spheres=group("spheres", T.Spheres),
        cones=optional("cones", T.Cones),
        lights=group("lights", T.Lights),
        materials=group("materials", T.Materials),
        textures=group("textures", T.Textures),
        bvh=group("bvh", T.BVH, leaf_size=leaf_size),
        fog=optional("fog", T.Fog),
        world_min=_tensor(arrays["world_min"], dev, dtype),
        world_max=_tensor(arrays["world_max"], dev, dtype),
        all_opaque=bool(all_opaque), has_image_tex=bool(has_image_tex))


def scene_to_arrays(scene) -> dict:
    """Inverse of :func:`scene_from_arrays` for any object with the same
    field names (a port Scene, or a JAX Scene of numpy arrays)."""
    out = {}
    for group in _FIELDS:
        obj = getattr(scene, group)
        if obj is None:             # no cones, no fog
            continue
        for name in _FIELDS[group]:
            out[f"{group}.{name}"] = np.asarray(getattr(obj, name))
    out["world_min"] = np.asarray(scene.world_min)
    out["world_max"] = np.asarray(scene.world_max)
    return out


_FIELDS = {
    "tris": [f.name for f in dataclasses.fields(T.Triangles)],
    "spheres": [f.name for f in dataclasses.fields(T.Spheres)],
    "cones": [f.name for f in dataclasses.fields(T.Cones)],
    "fog": [f.name for f in dataclasses.fields(T.Fog)],
    "lights": [f.name for f in dataclasses.fields(T.Lights)],
    "materials": [f.name for f in dataclasses.fields(T.Materials)],
    "textures": [f.name for f in dataclasses.fields(T.Textures)],
    "bvh": [f.name for f in dataclasses.fields(T.BVH) if f.name != "leaf_size"],
}


def photon_batch_from_arrays(pos, dir, col, stored, device="cuda",
                             dtype=torch.float32) -> PhotonBatch:
    dev = resolve_device(device)
    return PhotonBatch(_tensor(pos, dev, dtype), _tensor(dir, dev, dtype),
                       _tensor(col, dev, dtype),
                       torch.from_numpy(np.asarray(stored, bool).copy()).to(dev))


def photon_map_from_arrays(arrays: dict, *, dims, window_cap, device="cuda",
                           dtype=torch.float32) -> PhotonMap:
    """A port ``PhotonMap`` from its fields as numpy arrays (``pos``,
    ``dir``, ``col``, ``valid``, ``cell_start``, ``grid_min``, ``inv_cell``,
    optional ``order``) plus the static ``dims`` and ``window_cap``."""
    dev = resolve_device(device)
    order = arrays.get("order")
    return PhotonMap(
        pos=_tensor(arrays["pos"], dev, dtype),
        dir=_tensor(arrays["dir"], dev, dtype),
        col=_tensor(arrays["col"], dev, dtype),
        valid=torch.from_numpy(np.asarray(arrays["valid"], bool).copy()).to(dev),
        cell_start=_tensor(arrays["cell_start"], dev),
        grid_min=_tensor(arrays["grid_min"], dev, dtype),
        inv_cell=_tensor(arrays["inv_cell"], dev, dtype),
        order=None if order is None else _tensor(order, dev),
        dims=tuple(int(d) for d in dims), window_cap=int(window_cap))


def config_from_dict(d: dict) -> RenderConfig:
    """A port ``RenderConfig`` from ``dataclasses.asdict`` of either
    package's config (unknown keys raise)."""
    kw = dict(d)
    if "ambient" in kw:
        kw["ambient"] = tuple(float(a) for a in kw["ambient"])
    return RenderConfig(**kw)
