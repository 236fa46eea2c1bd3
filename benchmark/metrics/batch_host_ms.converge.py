"""Mean host time from a batch's call into `render_sample` to its return,
over the window (with the wait for the live-lane count it includes)."""

import statistics


def read(run):
    return statistics.fmean(run.spans["unit_host"]) * 1e3
