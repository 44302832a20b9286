"""knn_vjp_ms: the median over the window's steps (``train.step`` root
spans of the program's telemetry) of the host ms a step spends in the
kNN VJP's ``knn.vjp`` spans (the caustic estimate's backward: the plain
whole-window estimator recomputed block by block under autograd)."""

import statistics

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    if not spans:
        return None
    steps = {sp.id: 0 for sp in _spans.named(spans, "train.step")
             if sp.parent is None}
    if not steps:
        return None
    for sp in _spans.named(spans, "knn.vjp"):
        if sp.root in steps:
            steps[sp.root] += sp.ns
    return statistics.median(steps.values()) / 1e6
