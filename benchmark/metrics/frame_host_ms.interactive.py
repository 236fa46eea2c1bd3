"""Mean host time of a frame's call into `render_sample`, over the
window."""

import statistics


def read(run):
    return statistics.fmean(run.spans["unit_host"]) * 1e3
