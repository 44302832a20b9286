"""The port's bench (``python -m gi_raytracer_tpu_torch.bench``) and its
``cli photons``/``cli bench`` subcommands on the CPU, at tiny sizes.

The bench prints the five metric lines of the root ``bench.py`` in its
order, the headline last, each with ``"backend": "torch-cpu"``; a metric
that fails prints an ``error`` line while the others still run, and the
bench exits 1.  ``cli photons`` prints the JAX package's ``[photons]``
line with the same stored count (the port draws the JAX package's
threefry streams), ``cli bench`` its ``primary_paths_per_s`` line."""

import argparse
import json
import math
import re

import pytest
import torch

from gi_raytracer_tpu_torch import bench, cli

# one intra-op thread a test worker, as tests/_torch_parity.py sets
torch.set_num_threads(1)

TINY = ["--device", "cpu", "--size", "16", "--spp", "2", "--depth", "3",
        "--photons", "500", "--train-size", "16", "--train-photons", "400",
        "--scene", "small", "--repeats", "1"]
NAMES = ["photons_emitted_per_s", "knn_gather_mphotons_per_s",
         "train_step_seconds", "rays_per_s_cornell_512_8spp_nophotons",
         "rays_per_s_cornell_512_8spp"]

SCN = """colorTex 0.9 0.9 0.9
colorTex 0 0 0
colorTex 0.8 0.3 0.2
mat 0 1 1 1
mat 0 1 0 0 1.5
mat 2 1 1 1
box 0 -3 0 7 0.2 7 0 0 0 0
box 3 0 0 0.2 6 6 0 0 0 2
sphere 0 -1.2 0 1.2 1
light 0 3 0 8 8 8 0.3
samples 1 1 0.05
photons 600
camera 0 0 -8 0 -1 0
"""


def _lines(out):
    return [json.loads(x) for x in out.strip().splitlines()]


def test_bench_prints_the_five_metrics_headline_last(capsys):
    assert bench.main(TINY) == 0
    lines = _lines(capsys.readouterr().out)
    assert [x["metric"] for x in lines] == NAMES
    for x in lines:
        assert x["backend"] == "torch-cpu" and "error" not in x
        assert math.isfinite(x["value"]) and x["value"] > 0, x
        assert len(x["repeats"]) == 1
    head = lines[-1]
    assert head["with_photon_map"] and "test.scn" in head["baseline_scene"]
    assert head["vs_baseline"] == pytest.approx(
        head["value"] / 1855723.7, rel=1e-6)
    assert lines[0]["stored"] > 0.9 * 500


def test_bench_metric_failure_is_reported_and_fails_the_run(capsys,
                                                            monkeypatch):
    def broken(self):
        raise RuntimeError("forced")

    monkeypatch.setattr(bench.Bench, "knn_gather_mphotons_per_s", broken)
    assert bench.main(TINY) == 1
    lines = _lines(capsys.readouterr().out)
    assert [x["metric"] for x in lines] == NAMES
    bad = lines[1]
    assert bad["error"] == "RuntimeError: forced" and "value" not in bad
    assert all(math.isfinite(x["value"]) for i, x in enumerate(lines)
               if i != 1)


def test_bench_has_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--repeats", "1"])


@pytest.fixture
def scn(tmp_path):
    path = tmp_path / "s.scn"
    path.write_text(SCN)
    return str(path)


def _jax_args(scn, **kw):
    a = dict(scene=scn, width=16, height=16, spp=0, max_depth=0,
             photons=None, no_photons=False)
    a.update(kw)
    return argparse.Namespace(**a)


def test_cli_photons_prints_the_jax_line(scn, capsys):
    from gi_raytracer_tpu import cli as jax_cli
    jax_cli.cmd_photons(_jax_args(scn))
    want = capsys.readouterr().out.splitlines()
    cli.main(["photons", scn, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    pat = re.compile(r"\[photons\] (\d+)/(\d+) stored \(\d+\.\d\ds\)")
    assert len(got) == len(want) == 2
    assert got[0].split(" (")[0] == want[0].split(" (")[0]    # [scene]
    g, w = pat.fullmatch(got[1]), pat.fullmatch(want[1])
    assert g and w and g.groups() == w.groups(), (got[1], want[1])
    assert int(g.group(2)) == 600 and int(g.group(1)) > 0


def test_cli_bench_prints_the_jax_line(scn, capsys):
    from gi_raytracer_tpu import cli as jax_cli
    jax_cli.cmd_bench(_jax_args(scn, spp=2, max_depth=2, no_photons=True))
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    cli.main(["bench", scn, "--device", "cpu", "-W", "16", "-H", "16",
              "--spp", "2", "--max-depth", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("[photons] ")
    got = json.loads(out[-1])
    assert set(got) == set(want)
    assert got["metric"] == want["metric"] == "primary_paths_per_s"
    assert (got["spp"], got["size"]) == (want["spp"], want["size"]) \
        == (2, [16, 16])
    assert got["value"] > 0 and got["unit"] == "paths/s"
