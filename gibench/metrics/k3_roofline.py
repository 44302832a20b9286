"""k3_roofline: the least time the card could take for the caustic
estimate's (K3, ``csrc/knn.cu``, both tiers) work of the window, over
K3's device time in the traced window, in percent.

The work of a frame is counted after the window on the queries of one
more frame, untimed, which is the same work as every frame of the
window: for each K3 call, ``peaks.bound`` of ``core/k3count.k3_work``
(8 operations a candidate of the 27-cell windows; the bytes of the
frozen ``k3_bytes`` count: what these queries need, not the whole
map), summed over the frame's calls."""

KERNELS = ("gi_knn_kernel", "gi_knn_focal_kernel")


def read(run):
    if run.dtrace is None or "k3" not in run.work:
        return None
    busy = run.dtrace.time(KERNELS)
    if busy <= 0:
        return None
    return 100.0 * len(run.jobs) * run.work["k3"]["least_s"] / busy
