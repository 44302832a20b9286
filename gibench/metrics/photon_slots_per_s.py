"""photon_slots_per_s: every slot of every map finished in the window
(``trace_photons`` then ``build_photon_map``) over the window's host
seconds."""


def read(run):
    return sum(run.units) / run.window_s
