"""The spans an adaptive render of the analytic Cornell box records on the
CPU (``gi_raytracer_tpu_torch.telemetry``): each ``wave`` span's
``blocks`` and ``lanes``, the route of each ``wave.trace``, and the
``trace.analytic`` spans of the analytic passes, which a scene without
spheres and cones never opens; and the benchmark's readers of them
(``gibench/metrics/active_block_pct.py``, ``waves_per_frame.py``,
``analytic_ms.py``) on synthetic spans, None where nothing was recorded
or the program has no ``telemetry`` module."""

import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gi_raytracer_tpu_torch import telemetry
from gi_raytracer_tpu_torch.config import RenderConfig
from gi_raytracer_tpu_torch.render import Camera, Renderer
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
from gi_raytracer_tpu_torch.scene.cornell import (CAMERA_LOOK_AT, CAMERA_POS,
                                                  cornell_box)
from gibench.core import spec

READERS = ("active_block_pct", "waves_per_frame", "analytic_ms")


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def _recorded_render(analytic: bool, adaptive: bool, integrator="auto"):
    scene = cornell_box(SceneBuilder, meshgen, full=False,
                        analytic=analytic).build(device="cpu")
    cfg = RenderConfig(min_samples=2, max_samples=6 if adaptive else 2,
                       adaptive=adaptive, noise_thresh=0.05, max_depth=2,
                       integrator=integrator)
    r = Renderer(scene, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT), cfg,
                 64, 64)
    with profile(activities=[ProfilerActivity.CPU]):
        r.render()
    return r, telemetry.records()


def test_adaptive_waves_record_their_blocks_and_lanes():
    r, spans = _recorded_render(analytic=True, adaptive=True)
    assert r.block_adaptive
    waves = [sp for sp in spans if sp.name == "wave"]
    assert len(waves) > 2
    assert [sp.attrs["blocks"] for sp in waves] == r.wave_blocks
    assert [sp.attrs["lanes"] for sp in waves] == [
        256 * b for b in r.wave_blocks]
    # later waves traced fewer than the frame's 16 blocks
    assert r.wave_blocks[0] == 16 and min(r.wave_blocks) < 16


def test_analytic_scene_takes_the_staged_route_and_spans_its_passes():
    r, spans = _recorded_render(analytic=True, adaptive=True)
    traces = [sp for sp in spans if sp.name == "wave.trace"]
    assert {sp.attrs["route"] for sp in traces} == {"staged"}
    passes = [sp for sp in spans if sp.name == "trace.analytic"]
    by_id = {sp.id: sp for sp in spans}
    # a closest-hit and a shadow trace a bounce, each under its wave.trace
    assert len(passes) == 2 * 2 * len(traces)
    assert {by_id[sp.parent].name for sp in passes} == {"wave.trace"}
    assert {sp.attrs["prims"] for sp in passes} == {3}
    waves = {sp.id: sp for sp in spans if sp.name == "wave"}
    for sp in passes:
        wave = waves[by_id[sp.parent].parent]
        assert sp.attrs["lanes"] == wave.attrs["lanes"]


@pytest.mark.parametrize("integrator, route", [("auto", "k1"),
                                               ("staged", "staged")])
def test_mesh_scene_opens_no_analytic_span(integrator, route):
    r, spans = _recorded_render(analytic=False, adaptive=False,
                                integrator=integrator)
    traces = [sp for sp in spans if sp.name == "wave.trace"]
    assert len(traces) == 2
    assert {sp.attrs["route"] for sp in traces} == {route}
    assert not [sp for sp in spans if sp.name == "trace.analytic"]
    # a full-frame wave counts the band's 4 x 4 blocks and every lane
    waves = [sp for sp in spans if sp.name == "wave"]
    assert {(sp.attrs["blocks"], sp.attrs["lanes"]) for sp in waves} == {
        (16, 64 * 64)}


class _Log:
    """Spans laid end to end, 1 ms apart."""

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


def _frames(blocks=((4, 2, 1), (4, 3)), analytic=True):
    """Frames of waves tracing ``blocks`` blocks each, of a 64x32 frame
    (8 blocks); every wave's trace holds two analytic passes of 1 + w and
    2 ms (``analytic``)."""
    log = _Log()
    for waves in blocks:
        frame = log.add("frame", 30)
        for w, b in enumerate(waves):
            wave = log.add("wave", 10, frame, wave=w, blocks=b,
                           lanes=256 * b)
            tr = log.add("wave.trace", 5, wave, route="staged")
            if analytic:
                log.add("trace.analytic", 1 + w, tr, lanes=256 * b, prims=3)
                log.add("trace.analytic", 2, tr, lanes=256 * b, prims=3)
    # a photon pass's passes belong to no wave
    root = log.add("photons", 5)
    rnd = log.add("photons.round", 4, root, route="staged")
    if analytic:
        log.add("trace.analytic", 50, rnd, lanes=100, prims=3)
    return log.spans


@pytest.fixture
def recorded(monkeypatch):
    def use(spans):
        monkeypatch.setattr(telemetry, "records", lambda: list(spans))
    return use


def _read(name):
    run = types.SimpleNamespace(cell=types.SimpleNamespace(
        traffic={"width": 64, "height": 32}))
    return spec.module("metrics", name).read(run)


def test_readers_of_adaptive_frames(recorded):
    recorded(_frames())
    assert _read("active_block_pct") == pytest.approx(100 * 14 / (5 * 8))
    assert _read("waves_per_frame") == pytest.approx(2.5)
    # a wave's passes: 3, 4, 5 ms in frame 0, and 3, 4 in frame 1
    assert _read("analytic_ms") == pytest.approx(4.0)


def test_analytic_ms_reads_none_without_analytic_spans(recorded):
    recorded(_frames(analytic=False))
    assert _read("analytic_ms") is None
    assert _read("waves_per_frame") == pytest.approx(2.5)


def test_active_block_pct_reads_none_without_the_blocks(recorded):
    """Waves of a program from before the ``blocks`` attribute."""
    spans = _frames()
    for sp in spans:
        sp.attrs.pop("blocks", None)
    recorded(spans)
    assert _read("active_block_pct") is None


@pytest.mark.parametrize("name", READERS)
def test_readers_of_nothing_read_none(recorded, name):
    recorded([])
    assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_without_the_programs_telemetry_read_none(recorded,
                                                          monkeypatch, name):
    """A program from before ``telemetry`` (here: its import fails)."""
    import gi_raytracer_tpu_torch
    recorded(_frames())
    assert _read(name) is not None
    monkeypatch.delattr(gi_raytracer_tpu_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "gi_raytracer_tpu_torch.telemetry",
                        None)
    assert _read(name) is None


def test_spans_cost_no_image_change():
    """The same adaptive render, recorded and not, gives the same image."""
    scene = cornell_box(SceneBuilder, meshgen, full=False,
                        analytic=True).build(device="cpu")
    cfg = RenderConfig(min_samples=2, max_samples=4, max_depth=2)
    r = Renderer(scene, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT), cfg,
                 32, 32)
    plain = r.render()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = r.render()
    assert torch.equal(plain, traced)
