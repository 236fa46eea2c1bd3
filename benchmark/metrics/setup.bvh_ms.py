"""The host span around the program's BVH build and quad pack
(`accel.bvh.build_accel`), in set-up."""


def read(run):
    s = run.spans.get("setup.bvh")
    return s[0] * 1e3 if s else None
