"""analytic_ms: the median over the window's waves of a wave's host ms in
``trace.analytic`` spans (the program's telemetry: the dense sphere and
cone passes layered over each closest-hit and shadow trace of the
staged wave).  None where no wave holds one (a scene without analytic
primitives, or a program from before the span)."""

import statistics

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    if not spans:
        return None
    by_id = {sp.id: sp for sp in spans}
    per = {sp.id: 0 for sp in _spans.named(spans, "wave")}

    def wave_of(sp):
        while sp is not None and sp.name != "wave":
            sp = by_id.get(sp.parent)
        return sp

    found = False
    for sp in _spans.named(spans, "trace.analytic"):
        w = wave_of(sp)
        if w is not None:
            per[w.id] += sp.ns
            found = True
    return statistics.median(per.values()) / 1e6 if found else None
