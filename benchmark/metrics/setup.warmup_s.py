"""Set-up from the end of the BVH build to the end of the warm-up: the
capacity probe (which loads, or first builds, the kernel library), the
target render of an optimisation, and the warm-up units."""


def read(run):
    parts = [run.spans.get(k) for k in
             ("setup.capacity", "setup.target", "setup.warmup_loop")]
    return sum(p[0] for p in parts if p) if any(parts) else None
