"""photon_round_k2_pct: the share of the photon pass's retry rounds that
ran as the round kernel, in percent: the ``photons.round`` spans of the
program's telemetry whose ``route`` is ``"k2"`` (one launch of the walk
kernel's photon-round policy) over all of them (the others ``"staged"``:
torch operations around K2 calls).  None where no round was recorded, or
where the rounds carry no route (a program from before the round
kernel)."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    if not spans:
        return None
    rounds = _spans.named(spans, "photons.round")
    if not any("route" in sp.attrs for sp in rounds):
        return None
    k2 = sum(sp.attrs.get("route") == "k2" for sp in rounds)
    return 100.0 * k2 / len(rounds)
