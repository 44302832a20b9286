"""syncs_per_map: the host syncs the program marks (``sync`` spans of its
telemetry) in the window's photon passes and grid builds (``photons`` and
``photons.grid`` root spans), over the maps (``photons`` root spans)."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    return (_spans.per_job(spans, "photons", roots=("photons.grid",))
            if spans else None)
