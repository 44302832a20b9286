"""A throwaway copy of the benchmark cell ``cornell_analytic.adaptive_map``
at a size the CPU runs in a minute: the same configuration (the analytic
Cornell box) and kind, 64x64, adaptive 4-12 spp at noise 0.0015, depth 4,
a 20,000-slot map in one chunk, and every 16x16 block judged, under the
cell's own limits.  ``write(root)`` writes its data files under ``root``
and returns a copy of ``BENCHMARK.json`` that names it, and the data
directories to pass to ``gibench.run``."""

from __future__ import annotations

import copy
import json
import os

from gibench.core import spec

CELL = "cornell_analytic.adaptive_map"
NAME = "tiny_analytic.adaptive"
TRAFFIC = {"kind": "adaptive", "width": 64, "height": 64, "min_spp": 4,
           "max_spp": 12, "noise_thresh": 0.0015, "depth": 4, "knn_k": 32,
           "photons": 20_000, "ray_chunk": 20_000, "check_blocks": 16}


def limits() -> dict:
    return spec._json(spec.HERE, "cells", CELL + ".json")["limits"]


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def write(root, **traffic) -> tuple:
    root = str(root)
    bench = copy.deepcopy(spec.load_benchmark())
    (conf,) = [c for c in bench["configs"] if c["name"] == "cornell_analytic"]
    bench["configs"] = [conf]
    _dump(os.path.join(root, "traffic", "tiny_adaptive.json"),
          dict(TRAFFIC, **traffic))
    _dump(os.path.join(root, "cells", NAME + ".json"), {"limits": limits()})
    bench["workloads"] = [{"name": NAME, "config": "cornell_analytic",
                           "traffic": "tiny_adaptive", "chips": 1,
                           "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [NAME] if CELL in m["workloads"] else []
    return bench, (root, spec.HERE)
