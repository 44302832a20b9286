"""setup_s: host seconds from the start of set-up (the nvcc and g++
builds where the checkout has none, the scene, the photon map, the
renderer or step, one warm-up job) to the window, ended by a synchronise.
"""


def read(run):
    return run.setup_s
