"""A configuration's scene and camera, for the program and the reference
alike: the configuration names a frozen generator of ``scenes/`` and its
arguments; each side passes its own ``SceneBuilder`` class."""

from __future__ import annotations

import math

from . import spec


def populate(builder_cls, config: dict):
    """The configuration's scene, added to a ``builder_cls()``; returns
    the builder (call ``.build(...)`` on it)."""
    mod_name, fn = config["generator"].split(".")
    mod = spec.module("scenes", mod_name)
    args = dict(config.get("args", {}))
    if config.get("meshgen"):
        return getattr(mod, fn)(builder_cls, spec.module("scenes", "meshgen"),
                                **args)
    return getattr(mod, fn)(builder_cls, **args)


def camera(config: dict, seed: int) -> tuple:
    """(pos, look_at) of the run: the configuration's camera, turned about
    the vertical axis through ``look_at`` by (seed mod ``yaw_steps``) of
    ``yaw_steps`` equal turns where the configuration gives them (the
    same scene and the same work from another side)."""
    pos = [float(x) for x in config["camera"]["pos"]]
    at = [float(x) for x in config["camera"]["look_at"]]
    steps = int(config["camera"].get("yaw_steps", 1))
    a = 2 * math.pi * (int(seed) % steps) / steps
    dx, dz = pos[0] - at[0], pos[2] - at[2]
    c, s = math.cos(a), math.sin(a)
    pos = [at[0] + c * dx + s * dz, pos[1], at[2] - s * dx + c * dz]
    return tuple(pos), tuple(at)


def seed_of(seed: int, i: int) -> int:
    """The seed of the i-th job of a run (a 64-bit mix of both)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + i * 0xBF58476D1CE4E5B9 + 1) \
        & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return (x * 0x94D049BB133111EB) & 0x7FFFFFFFFFFFFFFF
