"""The program's own records of a traced window: the spans and counters
of ``gi_raytracer_tpu_torch.telemetry``, which the program records while
a profiler runs (the traced window alone: set-up, the untimed frame after
the window and untraced runs record nothing).

Every reader of a metric taken from them returns None where nothing was
recorded, and where the program has no ``telemetry`` module (a checkout
from before it): such a run reports no such metric and raises nothing.
"""

from __future__ import annotations

import statistics


def telemetry():
    """The program's ``telemetry`` module, or None."""
    try:
        from gi_raytracer_tpu_torch import telemetry as t
    except ImportError:
        return None
    return t


def spans():
    """The window's spans, or None when nothing was recorded."""
    t = telemetry()
    return (t.records() or None) if t is not None else None


def named(records, name: str) -> list:
    return [sp for sp in records if sp.name == name]


def median_ms(records, name: str):
    """The median over their parents (the waves) of the host ms of the
    spans ``name`` under each, or None without one."""
    per: dict = {}
    for sp in named(records, name):
        per[sp.parent] = per.get(sp.parent, 0) + sp.ns
    return statistics.median(per.values()) / 1e6 if per else None


def per_job(records, jobs, roots=None, name: str = "sync"):
    """The spans ``name`` of the jobs (root spans named ``jobs``) and of
    the other roots named in ``roots``, over the jobs; None without a
    job."""
    n = len([sp for sp in records if sp.parent is None and sp.name == jobs])
    if not n:
        return None
    keep = {sp.id for sp in records if sp.parent is None
            and sp.name in (jobs, *(roots or ()))}
    return sum(sp.root in keep for sp in named(records, name)) / n
