"""A throwaway copy of the benchmark cell ``cornell_fog.render`` at a size
the CPU runs in seconds: the same kind and the same scene but for a
denser fog (so that many lanes scatter in a small frame) and the noise
grid's seed, 32x32, 2 spp, depth 3, every 16x16 block judged, under the
cell's own limits.  ``write(root, density, grid_seed)`` writes its data
files under ``root`` and returns a copy of ``BENCHMARK.json`` that names
them, and the data directories to pass to ``gibench.run``."""

from __future__ import annotations

import copy
import json
import os

from gibench.core import spec

CELL = "cornell_fog.render"
NAME = "tiny_fog.render"
DENSITY = 2.0
TRAFFIC = {"kind": "fog", "width": 32, "height": 32, "spp": 2, "depth": 3,
           "photons": 0, "check_blocks": 4}


def limits() -> dict:
    return spec._json(spec.HERE, "cells", CELL + ".json")["limits"]


def config(density=DENSITY, grid_seed=0) -> dict:
    """The cell's configuration with the fog's density and grid seed
    given."""
    conf = spec._json(spec.HERE, "configs", "cornell_fog.json")
    return dict(conf, args=dict(conf["args"], density=density,
                                seed=grid_seed))


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def write(root, density=DENSITY, grid_seed=0, **traffic) -> tuple:
    root = str(root)
    bench = copy.deepcopy(spec.load_benchmark())
    (conf,) = [c for c in bench["configs"] if c["name"] == "cornell_fog"]
    conf["file"] = os.path.join(root, "configs", "tiny_fog.json")
    _dump(conf["file"], config(density, grid_seed))
    bench["configs"] = [conf]
    _dump(os.path.join(root, "traffic", "tiny_fog.json"),
          dict(TRAFFIC, **traffic))
    _dump(os.path.join(root, "cells", NAME + ".json"), {"limits": limits()})
    bench["workloads"] = [{"name": NAME, "config": "cornell_fog",
                           "traffic": "tiny_fog", "chips": 1,
                           "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [NAME] if CELL in m["workloads"] else []
    return bench, (root, spec.HERE)
