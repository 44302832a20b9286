"""waves_per_frame: the ``wave`` spans of the program's telemetry over its
``frame`` spans: the waves a frame runs before no pixel is active (at
most the traffic's largest sample count)."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    if not spans:
        return None
    frames = len(_spans.named(spans, "frame"))
    return len(_spans.named(spans, "wave")) / frames if frames else None
