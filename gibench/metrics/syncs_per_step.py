"""syncs_per_step: the host syncs the program marks (``sync`` spans of its
telemetry, the kNN VJP's among them) in the window's gradient steps, over
the steps (``train.step`` root spans)."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    return _spans.per_job(spans, "train.step") if spans else None
