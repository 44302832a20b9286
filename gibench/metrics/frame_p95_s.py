"""frame_p95_s: the 95th percentile (nearest rank) of every frame's host
seconds in the window, each ended by a synchronise."""

from gibench.core.stats import p95


def read(run):
    return p95(run.jobs)
