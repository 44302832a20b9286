"""frame_s: the window's host seconds over the frames it finished (a
frame is one ``Renderer.render()`` to the finished image)."""


def read(run):
    return run.window_s / len(run.jobs)
