"""The profiler over the first units of a traced window, and what is read
from its trace.

`torch.profiler` records the host's operations and the device's kernels,
copies and fills; the trace is written to a temporary file, read back as
plain events and deleted.  From it:

- the device intervals (kernels, copies, fills) and their union, `busy_s`,
  over the traced window `window_s` (the first to the last event);
- kernel time by name and by family (a frozen copy of the port's profile
  scripts' `FAMILIES`), and the kernels launched from a thread other than
  the loop's own, which is autograd's backward;
- launches: the kernel launches the host issued;
- the device's idle gaps, each named by what the host's loop thread was
  doing at its middle (the innermost operation), summed by name.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import torch

# Kernel families by substrings of the kernel's name (lower case), first
# match wins: a copy of scripts/torch_profile_step.py's FAMILIES, plus K1
# by its file's name.
FAMILIES = (
    ("walk", ("quad_traverse", "wide_traverse")),
    ("brute-force search", ("intersect_nearest",)),
    ("sort", ("sort",)),
    ("index / gather / scatter", ("index", "gather", "scatter")),
    ("reduce", ("reduce",)),
    ("copy / fill", ("memcpy", "memset", "fill", "copy")),
    ("elementwise", ("elementwise", "vectorized")),
)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def family(name):
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


class Tracer:
    """Starts and stops the profiler once; `summary` holds what was read."""

    def __init__(self):
        self.on = False
        self.summary = None
        self._prof = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self.on = True

    def stop(self, units):
        """Stop once the device has finished `units` units."""
        if not self.on:
            return
        self._prof.stop()
        self.on = False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            t = time.perf_counter()
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            self.summary = summarize(events, units)
            self.summary["read_s"] = time.perf_counter() - t
        finally:
            os.unlink(path)
            self._prof = None


def idle_pct(run):
    """100 x (traced window - busy) / traced window of a run's trace."""
    t = run.trace
    if not t["window_s"]:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]


def _union(intervals):
    """Merged [start, end) intervals of a sorted list."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events, units):
    """What a chrome trace of `units` units says; times in seconds."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    unit_tids = {e["tid"] for e in xs if e.get("name") == "bench.unit"}
    corr_tid = {}
    launches = 0
    host = []
    for e in xs:
        cat = e.get("cat", "")
        if cat in ("cuda_runtime", "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                corr_tid[c] = e["tid"]
            if "launch" in e["name"].lower() and "kernel" in e["name"].lower():
                launches += 1
        if cat in _HOST_CATS and e["tid"] in unit_tids:
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"]))
    dev = []
    kernel_s, family_s = {}, {}
    backward_s = 0.0
    for e in xs:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        dev.append((s, s + d))
        name = e["name"]
        if e["cat"] == "kernel":
            tid = corr_tid.get(e.get("args", {}).get("correlation"))
            if tid is not None and tid not in unit_tids:
                backward_s += d * 1e-6
        kernel_s[name] = kernel_s.get(name, 0.0) + d * 1e-6
        fam = family(name)
        family_s[fam] = family_s.get(fam, 0.0) + d * 1e-6
    dev.sort()
    busy = _union(dev)
    ends = [t for s, e, _ in host for t in (s, e)] + [t for iv in busy
                                                      for t in iv]
    lo, hi = (min(ends), max(ends)) if ends else (0.0, 0.0)
    gaps = []
    prev = lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    return {
        "units": units,
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "launches": launches,
        "kernel_s": kernel_s,
        "family_s": family_s,
        "backward_s": backward_s,
        "idle_by_host": _name_gaps(gaps, host),
    }


def _name_gaps(gaps, host):
    """Seconds of device idle by the innermost host operation of the loop
    thread at each gap's middle ("python" where none runs)."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    out = {}
    stack = []
    i = 0
    for g0, g1 in gaps:
        m = 0.5 * (g0 + g1)
        j = bisect.bisect_right(starts, m)
        while i < j:
            s, e, name = host[i]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        name = stack[-1][2] if stack else "python"
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-6
    return out
