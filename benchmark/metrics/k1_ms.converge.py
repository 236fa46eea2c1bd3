"""Device ms per batch in K1 (`quad_traverse*`, csrc/quad_traverse.cu),
in the traced batches."""


def read(run):
    t = run.trace
    s = sum(v for k, v in t["kernel_s"].items() if "quad_traverse" in k)
    return s / t["units"] * 1e3 if s else None
