"""Device ms per batch in kernels of the `sort` family, in the traced
batches."""


def read(run):
    s = run.trace["family_s"].get("sort")
    return s / run.trace["units"] * 1e3 if s else None
