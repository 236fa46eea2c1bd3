"""Kernel launches the host issued per batch, in the traced units."""


def read(run):
    return run.trace["launches"] / run.trace["units"]
