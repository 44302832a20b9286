"""k2_roofline: the least time the card could take for the photon pass's
dense trace (K2, ``csrc/intersect.cu`` on ``csrc/walk.cuh``) work of the
window, over its device time in the traced window, in percent.

The work of a map is counted on the reference's pass of the judged map
(the same rounds, rays and retries as the program's pass of that map)
and taken for every map of the window: each map has its own seed and so
its own retries, so the count of the others is approximate.  For each
trace call of R slots of which A are active, ``peaks.bound`` of
operations, one ray-triangle test (``OPS_PER_TEST``) an active ray, and
bytes, the scene's triangles (36 bytes each) read once, each slot's flag
read and answer written (5 bytes), each active ray's origin, direction,
limit and id read (32 bytes).  Never from the tests the kernel reports.
The walk kernel is K2 in this cell (the scene is under 16,384
triangles)."""

from gibench.core.peaks import OPS_PER_TEST, bound

KERNELS = ("gi_walk_kernel",)


def least_map_s(run) -> float:
    tris = run.work["tris"]
    return sum(bound(OPS_PER_TEST * a, tris * 36 + R * 5 + a * 32)[0]
               for R, a in run.work["k2_launches"])


def read(run):
    if run.dtrace is None or "k2_launches" not in run.work:
        return None
    busy = run.dtrace.time(KERNELS)
    if busy <= 0:
        return None
    return 100.0 * len(run.jobs) * least_map_s(run) / busy
