"""The readers of the metrics taken from the program's own records
(``metrics/_spans.py``) on synthetic spans and counts: each reads its
number, and None where nothing was recorded or the program has no
``telemetry`` module."""

import sys
import types

import pytest

from gibench.core import spec
from gi_raytracer_tpu_torch import telemetry

NEW = ("wave_inputs_ms", "wave_trace_ms", "syncs_per_frame", "k3_focal_pct",
       "rounds_per_map", "photon_live_pct", "syncs_per_map", "knn_vjp_ms",
       "syncs_per_step")


class _Log:
    """Spans laid end to end, 1 ms apart: ``add`` opens one under
    ``parent`` for ``ms`` milliseconds."""

    def __init__(self):
        self.spans, self.t = [], 0

    def add(self, name, ms=1.0, parent=None, **attrs):
        i = len(self.spans)
        root = i if parent is None else parent.root
        sp = telemetry.Span(name, self.t, self.t + int(ms * 1e6), i,
                            None if parent is None else parent.id, root,
                            attrs)
        self.t += 1_000_000
        self.spans.append(sp)
        return sp


def _frames():
    log = _Log()
    for f in range(2):
        frame = log.add("frame", 30)
        for w in range(3):
            wave = log.add("wave", 10, frame, wave=w)
            log.add("wave.inputs", 2 + w + f, wave)
            log.add("sync", 0.1, wave, site="wave.blocks")
            tr = log.add("wave.trace", 5, wave)
            log.add("knn", 1, tr, queries=1000)
            log.add("sync", 0.1, tr, site="mega.live")
            log.add("wave.fold", 1, wave)
            log.add("sync", 0.1, frame, site="frame.active")
    return log.spans


def _maps():
    log = _Log()
    for m in range(2):
        root = log.add("photons", 100)
        for c in range(2):
            for r in range(3):
                log.add("sync", 0.1, root, site="photons.live")
                log.add("photons.round", 5, root, round=r, lanes=100,
                        live=[100, 30, 10][r])
        grid = log.add("photons.grid", 5)
        log.add("sync", 0.1, grid, site="grid.stored")
    return log.spans


def _steps():
    log = _Log()
    for s, vjp in enumerate([(4, 2), (10,), (1, 1)]):
        step = log.add("train.step", 50)
        for ms in vjp:
            v = log.add("knn.vjp", ms, step, queries=10)
            log.add("sync", 0.1, v, site="knn.plain.live")
        log.add("sync", 0.1, step, site="ambient")
    return log.spans


# the jobs whose records each metric reads
JOBS = {"wave_inputs_ms": _frames, "wave_trace_ms": _frames,
        "syncs_per_frame": _frames, "k3_focal_pct": _frames,
        "rounds_per_map": _maps, "photon_live_pct": _maps,
        "syncs_per_map": _maps, "knn_vjp_ms": _steps,
        "syncs_per_step": _steps}


@pytest.fixture
def recorded(monkeypatch):
    def use(spans, k3=(0, 0)):
        monkeypatch.setattr(telemetry, "records", lambda: list(spans))
        monkeypatch.setattr(telemetry, "k3_counts", lambda: k3)
    return use


def _read(name):
    return spec.module("metrics", name).read(types.SimpleNamespace())


def test_frame_readers(recorded):
    recorded(_frames(), k3=(150, 150 + 132))
    # wave.inputs: 2, 3, 4 ms in frame 0 and 3, 4, 5 in frame 1
    assert _read("wave_inputs_ms") == pytest.approx(3.5)
    assert _read("wave_trace_ms") == pytest.approx(5.0)
    assert _read("syncs_per_frame") == pytest.approx(9.0)
    assert _read("k3_focal_pct") == pytest.approx(100 * 150 / 6000)


def test_wave_readers_sum_a_waves_spans(recorded):
    """An adaptive wave has two ``wave.inputs`` spans (its active blocks,
    then its inputs): the readers take each wave's sum."""
    log = _Log()
    frame = log.add("frame", 30)
    for w in range(3):
        wave = log.add("wave", 10, frame, wave=w)
        log.add("wave.inputs", 1, wave)
        log.add("wave.inputs", 2 + w, wave)
        log.add("wave.trace", 5, wave)
    recorded(log.spans)
    assert _read("wave_inputs_ms") == pytest.approx(4.0)    # of 3, 4, 5
    assert _read("wave_trace_ms") == pytest.approx(5.0)


def test_photon_readers(recorded):
    recorded(_maps())
    assert _read("rounds_per_map") == pytest.approx(6.0)
    assert _read("photon_live_pct") == pytest.approx(100 * 140 / 300)
    # six counts and the grid's sync a map
    assert _read("syncs_per_map") == pytest.approx(7.0)


def test_step_readers(recorded):
    recorded(_steps())
    assert _read("knn_vjp_ms") == pytest.approx(6.0)   # of 6, 10, 2
    assert _read("syncs_per_step") == pytest.approx(8 / 3)


@pytest.mark.parametrize("name", NEW)
def test_readers_of_nothing_read_none(recorded, name):
    recorded([])
    assert _read(name) is None
    # records of another kind of job only
    recorded(_frames() if JOBS[name] is _steps else _steps())
    assert _read(name) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_without_the_programs_telemetry_read_none(recorded,
                                                          monkeypatch, name):
    """A program from before ``telemetry`` (here: its import fails)."""
    import gi_raytracer_tpu_torch
    recorded(JOBS[name](), k3=(1, 1))
    assert _read(name) is not None
    monkeypatch.delattr(gi_raytracer_tpu_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "gi_raytracer_tpu_torch.telemetry",
                        None)
    assert _read(name) is None
