"""Throwaway cells at a size the CPU runs in seconds, written to a
directory of their own beside a copy of ``BENCHMARK.json`` that names
them: the data files a later cell adds, and nothing else."""

from __future__ import annotations

import copy
import json
import os

from gibench.core import spec

CONFIGS = {
    "tinybox": {"generator": "cornell.cornell_box", "meshgen": True,
                "args": {"full": False},
                "camera": {"pos": [0, 0, -14], "look_at": [0, 0, 0]}},
    "tinyterrain": {"generator": "terrain.terrain_scene", "meshgen": False,
                    "args": {"n": 20},
                    "camera": {"pos": [0, 18, -30], "look_at": [0, 0, 0],
                               "yaw_steps": 4}},
}
TRAFFIC = {
    "tmap": {"kind": "render", "width": 32, "height": 32, "spp": 2,
             "depth": 3, "knn_k": 8, "photons": 1200, "ray_chunk": 1024,
             "check_blocks": 2},
    "tplain": {"kind": "render", "width": 32, "height": 32, "spp": 2,
               "depth": 3, "photons": 0, "check_blocks": 2},
    "tpass": {"kind": "photons", "photons": 1200, "ray_chunk": 1024,
              "depth": 3},
    "tstep": {"kind": "train", "size": 16, "depth": 3, "knn_k": 8,
              "photons": 800},
}
# (cell, config, traffic, limits): limits loose enough for a sound run at
# this size on the CPU, far inside what a planted fault reads
CELLS = [
    ("tinybox.tmap", "tinybox", "tmap",
     {"photon_off": 0.05, "img_rel_l1": 0.02, "pix_off": 0.05}),
    ("tinyterrain.tplain", "tinyterrain", "tplain",
     {"img_rel_l1": 0.02, "pix_off": 0.05}),
    ("tinybox.tpass", "tinybox", "tpass",
     {"photon_off": 0.05, "grid_off": 0.0}),
    ("tinybox.tstep", "tinybox", "tstep",
     {"lcol_gap": 0.05, "pcol_off": 0.1, "loss_gap": 0.001,
      "pcol_gap": 0.05}),
]


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def write(root) -> dict:
    """Write the throwaway cells under ``root``; returns a copy of
    ``BENCHMARK.json`` whose configurations and cells are them."""
    root = str(root)
    bench = copy.deepcopy(spec.load_benchmark())
    bench["configs"] = []
    for name, conf in CONFIGS.items():
        path = os.path.join(root, "configs", name + ".json")
        _dump(path, dict(conf, name=name))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": path, "reduced": [],
                                 "why": "test"})
    for name, traffic in TRAFFIC.items():
        _dump(os.path.join(root, "traffic", name + ".json"), traffic)
    bench["workloads"] = []
    kinds = {}
    for cell, conf, traffic, limits in CELLS:
        _dump(os.path.join(root, "cells", cell + ".json"),
              {"limits": limits})
        bench["workloads"].append({"name": cell, "config": conf,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        kinds.setdefault(TRAFFIC[traffic]["kind"], []).append(cell)
    # each metric keeps to the throwaway cells of the kinds of its own
    old = {c["name"]: c for c in spec.load_benchmark()["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" not in m:
            continue
        ks = {spec._data((spec.HERE,), "traffic",
                         old[w]["traffic"])["kind"] for w in m["workloads"]}
        m["workloads"] = [c for k in ks for c in kinds.get(k, [])]
    return bench


def dirs(root) -> tuple:
    return (str(root), spec.HERE)
