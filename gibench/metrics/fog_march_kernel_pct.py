"""fog_march_kernel_pct: the share of the window's ``fog.march`` spans (the
program's telemetry: each march of a bounce or a shadow ray through the
fog) whose ``route`` is ``"kernel"``, in percent: the marches made by one
launch of the fog march kernel over all of them (the others ``"torch"``:
the blocked march's torch operations).  None where no span was recorded,
or where the spans carry no route (a program from before the kernel)."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    if not spans:
        return None
    marches = _spans.named(spans, "fog.march")
    if not any("route" in sp.attrs for sp in marches):
        return None
    kernel = sum(sp.attrs.get("route") == "kernel" for sp in marches)
    return 100.0 * kernel / len(marches)
