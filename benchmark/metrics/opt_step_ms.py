"""The window (host clock) over the optimisation steps finished in it."""


def read(run):
    return run.window.seconds / run.window.units * 1e3
