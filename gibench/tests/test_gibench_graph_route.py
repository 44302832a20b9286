"""The reader of ``wave_graph_pct`` on synthetic spans: the share of the
staged ``wave.trace`` spans with ``graph`` "replay", and None where nothing
was recorded, where no staged span carries the attribute (a program from
before the wave graph, or a frame of K1's waves) or where the program has
no ``telemetry`` module."""

import sys
import types

import pytest

from gibench.core import spec
from gi_raytracer_tpu_torch import telemetry


def _frame(waves):
    """A frame's root span and a ``wave`` span a (route, graph) pair, with
    its ``wave.trace`` span (graph None: a span without the attribute)."""
    spans = [telemetry.Span("frame", 0, 100, 0, None, 0, {})]
    for w, (route, graph) in enumerate(waves):
        wid = 1 + 2 * w
        attrs = {"route": route}
        if graph is not None:
            attrs["graph"] = graph
        spans += [telemetry.Span("wave", w, w + 1, wid, 0, 0, {"wave": w}),
                  telemetry.Span("wave.trace", w, w + 1, wid + 1, wid, 0,
                                 attrs)]
    return spans


def _read(monkeypatch, spans):
    monkeypatch.setattr(telemetry, "records", lambda: list(spans))
    return spec.module("metrics", "wave_graph_pct").read(
        types.SimpleNamespace())


@pytest.mark.parametrize("waves, share", [
    ([("staged", "replay")] * 4, 100.0),
    ([("staged", "replay")] * 8 + [("staged", "eager")] * 24, 25.0),
    ([("staged", "eager")] * 3, 0.0),
    ([("k1", "eager")] * 5 + [("staged", "replay")], 100.0)],
    ids=["all_replayed", "a_quarter", "none", "k1_waves_left_out"])
def test_wave_graph_pct_reads_the_share(monkeypatch, waves, share):
    assert _read(monkeypatch, _frame(waves)) == pytest.approx(share)


def test_wave_graph_pct_reads_none_without_the_attribute(monkeypatch):
    assert _read(monkeypatch, []) is None
    assert _read(monkeypatch, _frame([("staged", None)] * 2)) is None
    assert _read(monkeypatch, _frame([("k1", "eager")] * 2)) is None
    assert _read(monkeypatch, _frame([])) is None
    import gi_raytracer_tpu_torch
    monkeypatch.delattr(gi_raytracer_tpu_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "gi_raytracer_tpu_torch.telemetry",
                        None)
    assert _read(monkeypatch, _frame([("staged", "replay")])) is None
