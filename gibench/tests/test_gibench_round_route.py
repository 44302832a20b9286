"""The reader of ``photon_round_k2_pct`` on synthetic spans: the share of
the retry rounds with ``route`` "k2", and None where nothing was
recorded, where the rounds carry no route (a program from before the
round kernel) or where the program has no ``telemetry`` module."""

import sys
import types

import pytest

from gibench.core import spec
from gi_raytracer_tpu_torch import telemetry


def _rounds(routes):
    """A pass's root span and one ``photons.round`` span a route (None: a
    round without the attribute)."""
    root = telemetry.Span("photons", 0, 100, 0, None, 0, {})
    spans = [root]
    for r, route in enumerate(routes):
        attrs = {"round": r, "lanes": 100, "live": 50}
        if route is not None:
            attrs["route"] = route
        spans.append(telemetry.Span("photons.round", r, r + 1, r + 1, 0, 0,
                                    attrs))
    return spans


def _read(monkeypatch, spans):
    monkeypatch.setattr(telemetry, "records", lambda: list(spans))
    return spec.module("metrics", "photon_round_k2_pct").read(
        types.SimpleNamespace())


@pytest.mark.parametrize("routes, share", [
    (["k2"] * 6, 100.0),
    (["k2", "staged", "staged", "k2"], 50.0),
    (["staged"] * 3, 0.0)])
def test_photon_round_k2_pct_reads_the_share(monkeypatch, routes, share):
    assert _read(monkeypatch, _rounds(routes)) == pytest.approx(share)


def test_photon_round_k2_pct_reads_none_without_routes(monkeypatch):
    assert _read(monkeypatch, []) is None
    assert _read(monkeypatch, _rounds([None, None])) is None
    assert _read(monkeypatch, _rounds([])) is None
    import gi_raytracer_tpu_torch
    monkeypatch.delattr(gi_raytracer_tpu_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "gi_raytracer_tpu_torch.telemetry",
                        None)
    assert _read(monkeypatch, _rounds(["k2"])) is None
