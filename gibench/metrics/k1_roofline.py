"""k1_roofline: the least time the card could take for the frame loop's
megakernel (K1, ``csrc/megakernel.cu``) work of the window, over K1's
device time in the traced window, in percent.

The least time of a wave is ``peaks.bound`` of: operations, one
ray-triangle test (``OPS_PER_TEST``) for every ray the wave traces (the
floor of a closest hit or an occlusion test per ray; the rays are the
reference's, counted on its blocks and scaled to the frame, never the
program's counter); bytes, the scene's triangles (v0, e1, e2: 36 bytes each)
read once, and each lane's inputs (origin and direction 24, two sample
floats a bounce, lane id 4) read once and its radiance (12) written once.
Counted from the cell's inputs and the traced rays, never from the tests
a kernel reports.  The caustic estimate is K3's (``k3_roofline``)."""

from gibench.core.peaks import OPS_PER_TEST, bound

KERNELS = ("gi_mega_kernel",)


def least_frame_s(run) -> float:
    w = run.work
    waves = w["waves_per_frame"]
    rays = w["ref_rays_per_frame"] / waves
    lane_bytes = 24 + 8 * w["depth"] + 4 + 12
    t, _ = bound(OPS_PER_TEST * rays,
                 w["tris"] * 36 + w["lanes_per_wave"] * lane_bytes)
    return waves * t


def read(run):
    if run.dtrace is None or "ref_rays_per_frame" not in run.work:
        return None
    busy = run.dtrace.time(KERNELS)
    if busy <= 0:
        return None
    return 100.0 * len(run.jobs) * least_frame_s(run) / busy
