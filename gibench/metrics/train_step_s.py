"""train_step_s: the window's host seconds over the steps it finished (a
step is one ``TrainStep`` call: forward, backward and both gradients)."""


def read(run):
    return run.window_s / len(run.jobs)
