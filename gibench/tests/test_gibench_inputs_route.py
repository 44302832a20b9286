"""The reader of ``wave_inputs_kernel_pct`` on synthetic spans: the share of
the ``wave.inputs`` spans with ``route`` "kernel", and None where nothing
was recorded, where the spans carry no route (a program from before the
wave-inputs kernel) or where the program has no ``telemetry`` module."""

import sys
import types

import pytest

from gibench.core import spec
from gi_raytracer_tpu_torch import telemetry


def _frame(routes):
    """A frame's root span, a ``wave`` span a route and under each one
    ``wave.inputs`` span (None: a span without the attribute) beside its
    ``wave.trace``."""
    spans = [telemetry.Span("frame", 0, 100, 0, None, 0, {})]
    for w, route in enumerate(routes):
        wid = 1 + 3 * w
        attrs = {} if route is None else {"route": route}
        spans += [telemetry.Span("wave", w, w + 1, wid, 0, 0, {"wave": w}),
                  telemetry.Span("wave.inputs", w, w + 1, wid + 1, wid, 0,
                                 attrs),
                  telemetry.Span("wave.trace", w, w + 1, wid + 2, wid, 0,
                                 {"route": "k1"})]
    return spans


def _read(monkeypatch, spans):
    monkeypatch.setattr(telemetry, "records", lambda: list(spans))
    return spec.module("metrics", "wave_inputs_kernel_pct").read(
        types.SimpleNamespace())


@pytest.mark.parametrize("routes, share", [
    (["kernel"] * 8, 100.0),
    (["kernel", "torch", "torch", "kernel"], 50.0),
    (["torch"] * 3, 0.0)])
def test_wave_inputs_kernel_pct_reads_the_share(monkeypatch, routes, share):
    assert _read(monkeypatch, _frame(routes)) == pytest.approx(share)


def test_wave_inputs_kernel_pct_reads_none_without_routes(monkeypatch):
    assert _read(monkeypatch, []) is None
    assert _read(monkeypatch, _frame([None, None])) is None
    assert _read(monkeypatch, _frame([])) is None
    import gi_raytracer_tpu_torch
    monkeypatch.delattr(gi_raytracer_tpu_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "gi_raytracer_tpu_torch.telemetry",
                        None)
    assert _read(monkeypatch, _frame(["kernel"])) is None
