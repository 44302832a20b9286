"""kernels_per_map: device operations (kernels, copies and fills) in the
traced window over the maps it finished: how much the host issues
a map, which paces photon_slots_per_s while the device idles."""


def read(run):
    if run.dtrace is None:
        return None
    return run.dtrace.launches() / len(run.jobs)
