"""Kernel launches the host issued per optimisation step, in the traced
steps."""


def read(run):
    return run.trace["launches"] / run.trace["units"]
