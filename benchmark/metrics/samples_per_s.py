"""Pixel-samples finished in the window over the window (host clock): a
batch counts once its completion has been seen."""


def read(run):
    w, r = run.window, run.config["render"]
    return w.units * r["width"] * r["height"] * r["spp"] / w.seconds
