"""The readers of the fog march's metrics (``fog_march_ms``,
``fog_lane_steps_per_frame``) on synthetic spans: each reads its number,
and None where no ``fog.march`` span was recorded (a program from before
the span, or a frame without fog) or the program has no ``telemetry``
module."""

import sys
import types

import pytest

from gibench.core import spec
from gibench.tests.test_gibench_spans import _Log, _frames, recorded  # noqa: F401
from gi_raytracer_tpu_torch import telemetry

NAMES = ("fog_march_ms", "fog_lane_steps_per_frame")


def _fog_frames():
    """Two frames of two waves; each wave's trace holds a scattering
    march and, under a shadow trace, a shadow march (2 + w + f ms and
    1 ms), each with a block's sync."""
    log = _Log()
    for f in range(2):
        frame = log.add("frame", 40)
        for w in range(2):
            wave = log.add("wave", 15, frame, wave=w)
            tr = log.add("wave.trace", 10, wave)
            m = log.add("fog.march", 2 + w + f, tr, use="scatter",
                        lanes=100, blocks=2, lane_steps=100 * 32 + 40 * 32)
            log.add("sync", 0.1, m, site="fog.block")
            shadow = log.add("trace.shadow", 3, tr)
            log.add("fog.march", 1, shadow, use="shadow", lanes=50,
                    blocks=1, lane_steps=50 * 32)
    return log.spans


def _read(name):
    return spec.module("metrics", name).read(types.SimpleNamespace())


def test_fog_readers(recorded):  # noqa: F811
    recorded(_fog_frames())
    # a wave's marches: 3, 4 ms in frame 0, 4, 5 in frame 1
    assert _read("fog_march_ms") == pytest.approx(4.0)
    assert _read("fog_lane_steps_per_frame") == pytest.approx(
        2 * (4480 + 1600))


@pytest.mark.parametrize("name", NAMES)
def test_fog_readers_of_nothing_read_none(recorded, name):  # noqa: F811
    recorded([])
    assert _read(name) is None
    # frames without fog: a program from before the span reads so too
    recorded(_frames())
    assert _read(name) is None


@pytest.mark.parametrize("name", NAMES)
def test_fog_readers_without_the_programs_telemetry_read_none(
        recorded, monkeypatch, name):  # noqa: F811
    import gi_raytracer_tpu_torch
    recorded(_fog_frames())
    assert _read(name) is not None
    monkeypatch.delattr(gi_raytracer_tpu_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "gi_raytracer_tpu_torch.telemetry",
                        None)
    assert _read(name) is None
