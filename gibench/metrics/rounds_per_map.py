"""rounds_per_map: the photon pass's retry rounds (``photons.round``
spans of the program's telemetry) over the window's maps (``photons``
root spans, one ``trace_photons`` each): at most photon_retries a chunk,
each round tracing every slot of its chunk."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    return (_spans.per_job(spans, "photons", name="photons.round")
            if spans else None)
