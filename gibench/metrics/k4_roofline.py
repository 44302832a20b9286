"""k4_roofline: the least time the card could take for the big-mesh
trace's (K4, ``csrc/stream.cu`` on ``csrc/walk.cuh``) work of the window,
over its device time in the traced window, in percent.

A frame traces spp x depth closest-hit calls and as many shadow calls a
light.  Its least time is ``peaks.bound`` of: operations, one ray-triangle
test (``OPS_PER_TEST``) for every ray traced (the reference's rays,
counted on its blocks and scaled to the frame, never the program's
counter); bytes, the scene's triangles (v0, e1, e2: 36 bytes each) read
once a trace call, and each ray's origin, direction, limit, flag and id
(37 bytes with its answer) once.  Counted from the cell's inputs and the
traced rays, never from the tests the kernel reports.  The walk kernel is
K4 in this cell (past 16,384 triangles K2 never runs)."""

from gibench.core.peaks import OPS_PER_TEST, bound

KERNELS = ("gi_walk_kernel",)


def least_frame_s(run) -> float:
    w = run.work
    rays = w["ref_rays_per_frame"]
    calls = w["waves_per_frame"] * w["depth"] * (1 + w["lights"])
    t, _ = bound(OPS_PER_TEST * rays, calls * w["tris"] * 36 + rays * 37)
    return t


def read(run):
    if run.dtrace is None or "ref_rays_per_frame" not in run.work:
        return None
    busy = run.dtrace.time(KERNELS)
    if busy <= 0:
        return None
    return 100.0 * len(run.jobs) * least_frame_s(run) / busy
