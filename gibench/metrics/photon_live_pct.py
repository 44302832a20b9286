"""photon_live_pct: the share of the lanes the photon pass's retry rounds
trace that are slots still unstored, in percent: the sum of the rounds'
``live`` over the sum of their ``lanes`` (``photons.round`` spans of the
program's telemetry): the pass's useful work over its attempts."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    if not spans:
        return None
    rounds = [sp for sp in _spans.named(spans, "photons.round")
              if "live" in sp.attrs]
    lanes = sum(sp.attrs["lanes"] for sp in rounds)
    if not lanes:
        return None
    return 100.0 * sum(sp.attrs["live"] for sp in rounds) / lanes
