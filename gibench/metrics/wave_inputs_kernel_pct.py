"""wave_inputs_kernel_pct: the share of the window's ``wave.inputs`` spans
(the program's telemetry: a wave's set-up, and an adaptive wave's active
blocks) whose ``route`` is ``"kernel"``, in percent: the set-ups drawn by
one launch of the wave-inputs kernel (its Halton dims and primary rays)
over all of them (the others ``"torch"``: torch operations).  None where
no span was recorded, or where the spans carry no route (a program from
before the kernel)."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    if not spans:
        return None
    inputs = _spans.named(spans, "wave.inputs")
    if not any("route" in sp.attrs for sp in inputs):
        return None
    kernel = sum(sp.attrs.get("route") == "kernel" for sp in inputs)
    return 100.0 * kernel / len(inputs)
