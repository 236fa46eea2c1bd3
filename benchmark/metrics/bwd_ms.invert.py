"""Device ms per step in kernels launched from autograd's backward
thread, in the traced steps."""


def read(run):
    t = run.trace
    return t["backward_s"] / t["units"] * 1e3 if t["backward_s"] else None
