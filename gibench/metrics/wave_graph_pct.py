"""wave_graph_pct: the share of the window's staged waves issued as one
CUDA graph's replay, in percent: the ``wave.trace`` spans of the program's
telemetry whose ``route`` is ``"staged"`` and whose ``graph`` is
``"replay"`` (the full band's staged wave, captured once and replayed)
over the staged ``wave.trace`` spans (the others ``"eager"``: torch
operations issued one by one).  None where no span was recorded, or where
no staged span carries the attribute (a program from before the graph,
or a cell of K1's waves)."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    if not spans:
        return None
    staged = [sp for sp in _spans.named(spans, "wave.trace")
              if sp.attrs.get("route") == "staged"]
    if not any("graph" in sp.attrs for sp in staged):
        return None
    replay = sum(sp.attrs.get("graph") == "replay" for sp in staged)
    return 100.0 * replay / len(staged)
