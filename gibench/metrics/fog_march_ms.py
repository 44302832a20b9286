"""fog_march_ms: the median over the window's waves of a wave's host ms in
``fog.march`` spans (the program's telemetry: the fog march of each
bounce and each shadow ray of the staged wave, its host waits included).
None where no wave holds one (a scene without fog, or a program from
before the span)."""

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
    for sp in _spans.named(spans, "fog.march"):
        w = wave_of(sp)
        if w is not None:
            per[w.id] += sp.ns
            found = True
    return statistics.median(per.values()) / 1e6 if found else None
