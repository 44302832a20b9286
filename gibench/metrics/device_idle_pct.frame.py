"""device_idle_pct.frame: the share of the traced window in which no
operation ran on the device (100 * (1 - busy / window)), busy being the
union of the profiler's device events."""


def read(run):
    if run.dtrace is None:
        return None
    return 100.0 * (1.0 - run.dtrace.busy_s / run.window_s)
