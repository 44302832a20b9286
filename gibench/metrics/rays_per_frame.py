"""rays_per_frame: the program's ``rays`` counter of the last frame of the
window (alive closest-hit lanes plus issued shadow rays, every wave):
the frame loop's work, the same in every frame of a run."""


def read(run):
    return run.counts.get("rays_per_frame")
