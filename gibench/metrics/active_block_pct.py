"""active_block_pct: the share of the window's block-waves that a wave
traced, in percent: the sum of the ``wave`` spans' ``blocks`` (the 16x16
blocks the wave traced, in the program's telemetry) over the waves times
the frame's blocks (the traffic's width and height in 16x16 blocks).  An
adaptive frame traces a block while any pixel in it is active; a
fixed-spp frame reads 100.  None where no wave carries ``blocks`` (a
program from before the attribute)."""

from gibench.metrics import _spans


def read(run):
    spans = _spans.spans()
    if not spans:
        return None
    waves = [sp for sp in _spans.named(spans, "wave") if "blocks" in sp.attrs]
    if not waves:
        return None
    tr = run.cell.traffic
    per_frame = -(-int(tr["width"]) // 16) * -(-int(tr["height"]) // 16)
    traced = sum(sp.attrs["blocks"] for sp in waves)
    return 100.0 * traced / (len(waves) * per_frame)
