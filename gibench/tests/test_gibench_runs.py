"""Whole runs on the CPU, of throwaway cells added as data files only
(``tiny.py``): a sound run is correct, the control and each planted fault
of the timed path are not.  The runs skip the look for a card and run the
program's plain versions; ``device="cpu"`` exists for these tests alone.

On the card, ``test_control_fails_at_the_cells_own_size`` runs the
control of every cell of ``BENCHMARK.json`` at its own size."""

import pytest
import torch

from gibench import run as bench_run
from gibench.core import spec
from gibench.tests import tiny

SEED = 2**31 + 11


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    root = tmp_path_factory.mktemp("cells")
    return tiny.write(root), tiny.dirs(root)


def _run(cells, name, seconds=0.2):
    bench, dirs = cells
    return bench_run.run_cell(bench, name, SEED, seconds, False,
                              device="cpu", data_dirs=dirs)


@pytest.mark.parametrize("name", [c[0] for c in tiny.CELLS])
def test_a_throwaway_cell_runs_and_is_correct(cells, name):
    line = _run(cells, name)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("name", [c[0] for c in tiny.CELLS])
def test_the_control_is_not_correct(cells, name):
    bench, dirs = cells
    line = bench_run.run_control(bench, name, SEED, device="cpu",
                                 data_dirs=dirs)
    assert not line["correct"], line["checks"]


def _planted(monkeypatch, target, name, wrap):
    orig = getattr(target, name)
    monkeypatch.setattr(target, name, wrap(orig))


def _render_fault(kind):
    def wrap(orig):
        def render(self, *a, **kw):
            out = orig(self, *a, **kw)
            img = out[0] if isinstance(out, tuple) else out
            if kind == "unchanged":
                bad = torch.full_like(img, 0.5)
            elif kind == "half":
                bad = img.clone()
                bad[1::2] = img[0::2]
            else:
                bad = img * 1.1
            return (bad, out[1]) if isinstance(out, tuple) else bad
        return render
    return wrap


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ["tinybox.tmap", "tinyterrain.tplain"])
def test_a_broken_frame_is_not_correct(cells, monkeypatch, name, fault):
    from gi_raytracer_tpu_torch.render.integrator import Renderer
    _planted(monkeypatch, Renderer, "render", _render_fault(fault))
    assert not _run(cells, name)["correct"]


def _pass_fault(kind):
    def wrap(orig):
        def trace_photons(*a, **kw):
            b = orig(*a, **kw)
            if kind == "unchanged":
                return b._replace(stored=torch.zeros_like(b.stored))
            if kind == "half":
                keep = torch.arange(b.pos.shape[0]) % 2 == 0
                return b._replace(stored=b.stored & keep)
            pos = b.pos.clone()
            pos[::10] += 0.01
            return b._replace(pos=pos)
        return trace_photons
    return wrap


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_photon_pass_is_not_correct(cells, monkeypatch, fault):
    from gi_raytracer_tpu_torch.render import photon
    _planted(monkeypatch, photon, "trace_photons", _pass_fault(fault))
    from gibench.kinds import photons  # noqa: F401  (the kind's import)
    assert not _run(cells, "tinybox.tpass")["correct"]


def _step_fault(kind):
    def wrap(orig):
        def call(self, *a, **kw):
            if kind == "half":
                # the step over the first half of its lanes: the loss is
                # the mean over the rest
                saved = self.inputs, self.lane, self.target
                ro, rd, sx, sy = self.inputs
                h = ro.shape[0] // 2
                self.inputs = (ro[:h], rd[:h], sx[:, :h], sy[:, :h])
                self.lane, self.target = self.lane[:h], self.target[:h]
                try:
                    return orig(self, *a, **kw)
                finally:
                    self.inputs, self.lane, self.target = saved
            loss, g_pcol, g_lcol = orig(self, *a, **kw)
            if kind == "unchanged":
                return loss, torch.zeros_like(g_pcol), torch.zeros_like(
                    g_lcol)
            return loss, g_pcol, g_lcol * 1.1
        return call
    return wrap


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_step_is_not_correct(cells, monkeypatch, fault):
    from gi_raytracer_tpu_torch.train import TrainStep
    _planted(monkeypatch, TrainStep, "__call__", _step_fault(fault))
    assert not _run(cells, "tinybox.tstep")["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_control_fails_at_the_cells_own_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line = bench_run.run_control(spec.load_benchmark(), name, SEED)
    assert not line["correct"], line["checks"]
