"""kernels_per_step: device operations (kernels, copies and fills) in the
traced window over the steps it finished: how much the host issues
a step, which paces train_step_s while the device idles."""


def read(run):
    if run.dtrace is None:
        return None
    return run.dtrace.launches() / len(run.jobs)
