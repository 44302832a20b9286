"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) brings together its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``,
whose ``kind`` names a module of ``kinds/``), its own limits
(``cells/<cell>.json``) and the metrics that apply to it: an end-to-end
or per-layer metric applies to every cell, or to those its
``workloads`` key lists.  Each metric is read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(root, "BENCHMARK.json")


def module(folder: str, name: str):
    """``gibench/<folder>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(HERE, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"gibench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configs/<config>.json object
    traffic: dict         # the traffic/<traffic>.json object
    limits: dict          # cells/<cell>.json "limits": name -> limit
    end_to_end: list      # BENCHMARK.json entries that apply to the cell
    per_layer: list


def _data(dirs, folder, name):
    """``<dir>/<folder>/<name>.json`` of the first of ``dirs`` that holds
    it (the tests add a directory of throwaway cells before ``HERE``)."""
    for d in dirs:
        path = os.path.join(d, folder, name + ".json")
        if os.path.exists(path):
            return _json(path)
    raise FileNotFoundError(f"no {folder}/{name}.json")


def cell(bench: dict, name: str, data_dirs=(HERE,)) -> Cell:
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(ROOT, conf["file"]),
        traffic=_data(data_dirs, "traffic", w["traffic"]),
        limits=_data(data_dirs, "cells", name)["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])
