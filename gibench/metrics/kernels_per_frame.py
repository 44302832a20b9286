"""kernels_per_frame: device operations (kernels, copies and fills) in the
traced window over the frames it finished: how much the host issues
a frame, which paces frame_s while the device idles."""


def read(run):
    if run.dtrace is None:
        return None
    return run.dtrace.launches() / len(run.jobs)
