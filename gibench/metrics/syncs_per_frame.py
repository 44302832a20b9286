"""syncs_per_frame: the host syncs the program marks (``sync`` spans of
its telemetry) in the window's frames, over the frames (``frame`` root
spans): each one a point where the host waits for the card."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    return _spans.per_job(spans, "frame") if spans else None
