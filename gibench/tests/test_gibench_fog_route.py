"""The reader of ``fog_march_kernel_pct`` on synthetic spans: the share of
the ``fog.march`` spans with ``route`` "kernel", and None where nothing was
recorded, where the spans carry no route (a program from before the fog
march kernel) or where the program has no ``telemetry`` module."""

import sys
import types

import pytest

from gibench.core import spec
from gi_raytracer_tpu_torch import telemetry


def _frame(routes):
    """A frame's root span, a ``wave`` span and its ``wave.trace``, and
    under the trace one ``fog.march`` span a route (None: a span without
    the attribute), scattering and shadow marches in turn."""
    spans = [telemetry.Span("frame", 0, 100, 0, None, 0, {}),
             telemetry.Span("wave", 0, 90, 1, 0, 0, {"wave": 0}),
             telemetry.Span("wave.trace", 0, 80, 2, 1, 0,
                            {"route": "staged", "graph": "eager"})]
    for m, route in enumerate(routes):
        attrs = {"use": ("scatter", "shadow")[m % 2], "lanes": 10,
                 "blocks": 1, "lane_steps": 320}
        if route is not None:
            attrs["route"] = route
        spans.append(telemetry.Span("fog.march", m, m + 1, 3 + m, 2, 0,
                                    attrs))
    return spans


def _read(monkeypatch, spans):
    monkeypatch.setattr(telemetry, "records", lambda: list(spans))
    return spec.module("metrics", "fog_march_kernel_pct").read(
        types.SimpleNamespace())


@pytest.mark.parametrize("routes, share", [
    (["kernel"] * 48, 100.0),
    (["torch"] * 6, 0.0),
    (["kernel", "torch", "torch", "kernel", "kernel", "kernel"],
     100.0 * 4 / 6)],
    ids=["kernel", "torch", "mixed"])
def test_fog_march_kernel_pct_reads_the_share(monkeypatch, routes, share):
    assert _read(monkeypatch, _frame(routes)) == pytest.approx(share)


def test_fog_march_kernel_pct_reads_none_without_routes(monkeypatch):
    assert _read(monkeypatch, []) is None
    # a program from before the kernel: marches without a route
    assert _read(monkeypatch, _frame([None, None])) is None
    # a frame without fog
    assert _read(monkeypatch, _frame([])) is None
    import gi_raytracer_tpu_torch
    monkeypatch.delattr(gi_raytracer_tpu_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "gi_raytracer_tpu_torch.telemetry",
                        None)
    assert _read(monkeypatch, _frame(["kernel"])) is None
