"""fog_lane_steps_per_frame: the march's work a frame: the ``lane_steps``
of the ``fog.march`` spans in the window's frames (each march's blocks of
steps times the lanes marching them, in the program's telemetry), over
the frames (``frame`` root spans).  None where no such span carries
``lane_steps`` (a scene without fog, or a program from before the
span)."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    if not spans:
        return None
    frames = {sp.id for sp in spans if sp.parent is None
              and sp.name == "frame"}
    marches = [sp for sp in _spans.named(spans, "fog.march")
               if sp.root in frames and "lane_steps" in sp.attrs]
    if not marches:
        return None
    return sum(sp.attrs["lane_steps"] for sp in marches) / len(frames)
