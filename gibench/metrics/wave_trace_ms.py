"""wave_trace_ms: the median over the window's waves of the host ms of a
wave's ``wave.trace`` span (the program's telemetry): its dispatch, K1
and its caustic estimate, or the staged wave on K4 or K2."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    return _spans.median_ms(spans, "wave.trace") if spans else None
