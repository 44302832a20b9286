"""wave_inputs_ms: the median over the window's waves of the host ms of a
wave's ``wave.inputs`` spans (the program's telemetry): its set-up, the
Halton dims, primary rays and bounce samples (and the active blocks of an
adaptive frame, a span of their own), issued before its trace."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    return _spans.median_ms(spans, "wave.inputs") if spans else None
