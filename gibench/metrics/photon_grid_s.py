"""photon_grid_s: the median host seconds of ``build_photon_map`` over the
window's maps (synchronised on both ends): the grid build's share of a
map."""

import statistics


def read(run):
    spans = run.spans.get("photon_grid")
    return statistics.median(spans) if spans else None
