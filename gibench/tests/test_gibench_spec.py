"""BENCHMARK.json against the contract's form, and the layout that finds
every piece of a cell by name."""

import json
import os
import re

import pytest

from gibench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys_and_paths(bench):
    assert set(bench) == KEYS
    assert bench["paths"] == ["gibench"]
    assert 1 <= bench["run_seconds"] <= 51
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(bench, group):
    names = [e["name"] for e in bench[group]]
    assert len(names) == len(set(names))
    for e in bench[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end" and key != "source":
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_every_piece_of_every_cell_exists(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("gibench/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert len(c["source"]) <= 200
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        cell = spec.cell(bench, w["name"])
        spec.module("kinds", cell.traffic["kind"])
        assert cell.limits
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)


def test_each_cell_reports_setup_an_end_to_end_and_a_layer(bench):
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_every_layer_metric_moves_what_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert spec.applies(e2e[m["moves"]], w), (m["name"], w)


def test_end_to_end_bounds(bench):
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m for m in bench["end_to_end"]}["setup_s"][
        "bound"] == 0.25


def test_rooflines_are_named_and_in_percent(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """Without the program beside it (and, here, without a card) a run
    exits non-zero and prints nothing on standard output."""
    import shutil
    import subprocess
    import sys
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "gibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    res = subprocess.run(
        [sys.executable, *bench["command"][1:], "--workload",
         bench["workloads"][0]["name"], "--seed", "2147483659",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
