"""k3_focal_pct: the share of K3's queries that its warp tier queued for
the focal tier (windows past ``photon_knn.FOCAL`` candidates), in
percent: K3's focal-queued total over the window (the program's counter,
which the kernel adds to while the program records) over the queries of
the window's ``knn`` spans."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    if not spans:
        return None
    queries = sum(sp.attrs["queries"] for sp in _spans.named(spans, "knn"))
    if not queries:
        return None
    return 100.0 * _spans.telemetry().k3_counts()[0] / queries
