"""One run of one cell: set-up, the measured window, the check, the line.

Everything is found by name: the cell in BENCHMARK.json, its
configuration in the file the configuration names, its mix in
benchmark/traffic/<traffic>.json, its limits in
benchmark/limits/<cell>.json, and each metric's reader in
benchmark/metrics/<metric>.py (a function `read(run)` that returns the
number, or None when it finds nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import statistics
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dpt_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix, limits
    and the metrics it reports, with `--trace 0` and with `--trace 1`."""

    def __init__(self, name, bench=None):
        bench = bench or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json "
                             f"has {sorted(cells)}")
        self.name = name
        self.spec = cells[name]
        cfg = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        self.config = load_json(ROOT / cfg["file"])
        self.mix = load_json(HERE / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m["workloads"]]


def reader(metric):
    """The `read` function of benchmark/metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Run:
    """What the metric readers read: the cell, the spans, the window and
    the trace summary (None without --trace 1)."""

    def __init__(self, cell, spans, window, setup_s, trace, config):
        self.cell, self.spans, self.window = cell, spans, window
        self.setup_s, self.trace, self.config = setup_s, trace, config
        self.mix = cell.mix


def inputs_of(system):
    """The inputs both sides got, in the reference's terms."""
    c = system.config
    settings = dict(c["render"])
    settings.pop("compact_frac")
    return {
        "vertices": system.vertices, "indices": system.indices,
        "material": dict(c["material"]),
        "lights": [(lt["position"], lt["normal"], lt["intensity"],
                    lt["size"]) for lt in c["lights"]],
        "settings": settings,
    }


def judge(cell, inputs, outputs, seed, device, q=None):
    """(numbers, detail): what the check compares, for the window's
    outputs (or, with `q`, for the reference's control in their place)."""
    from benchmark.reference import check

    if cell.mix["loop"] == "optimize":
        return check.optimize(inputs, outputs, cell.mix, device, q)
    return check.progressive(inputs, outputs, seed, cell.mix["check_rows"],
                             device, q)


def measure(cell, seed, seconds, trace, device, overrides=None):
    """Set the program up and run the window.  Returns (inputs, outputs,
    window, spans, trace summary, config): the inputs both sides got and
    the program's outputs the check needs; the program's own state is
    freed.  `overrides` updates sections of the configuration (the CPU
    tests' small frames and meshes)."""
    import torch

    from benchmark import drive
    from benchmark.trace import Tracer

    config = json.loads(json.dumps(cell.config))
    for section, values in (overrides or {}).items():
        config[section].update(values)
    spans = drive.Spans()
    system = drive.System(config, cell.mix, seed, device, spans)
    tracer = Tracer() if trace else None
    window = drive.LOOPS[cell.mix["loop"]](system, seconds, tracer)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded in the measured process: {found}")
    # The program's state goes before the reference runs.
    inputs = inputs_of(system)
    outputs = dict(window.outputs, camera=system.camera_arrays)
    del system
    window.outputs = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return (inputs, outputs, window, spans.s,
            tracer.summary if tracer is not None else None, config)


def run_cell(cell, seed, seconds, trace, device, t_start, overrides=None):
    """Set up, measure, check.  Returns the result line (a dict), the
    lines of the check for standard error, and the check's detail."""
    import torch

    inputs, outputs, window, spans, summary, config = measure(
        cell, seed, seconds, trace, device, overrides)
    numbers, detail = judge(cell, inputs, outputs, seed, device)
    run = Run(cell, spans, window, window.t0 - t_start, summary, config)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    over = over_limits(cell, numbers)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(window.peak_bytes)}
    line = {"correct": not over, "attempted": window.units,
            "failed": len(over), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        line["breakdown"] = breakdown(summary)
    line["check"] = {k: {"value": v, "limit": cell.limits[k]}
                     for k, v in numbers.items()}
    notes = [f"check {k} {v!r} limit {cell.limits[k]!r}"
             for k, v in numbers.items()]
    if cell.mix.get("camera") == "drag" and len(window.unit_s) > 1:
        ms = [x * 1e3 for x in window.unit_s]
        q = statistics.quantiles(ms, n=100)
        notes.insert(0, f"frames {len(ms)} median_ms "
                        f"{statistics.median(ms)!r} p90_ms {q[89]!r} "
                        f"p99_ms {q[98]!r} max_ms {max(ms)!r}")
    return line, notes, detail


def over_limits(cell, numbers):
    """The numbers compared that are not within their limits."""
    return [k for k, v in numbers.items()
            if not (math.isfinite(v) and v <= cell.limits[k])]


def breakdown(summary):
    top = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v] for k, v in top],
            "idle_gaps": [[k[:160], v] for k, v in gaps]}


def main(args, t_start):
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    chips = cell.spec["chips"]
    if torch.cuda.device_count() < chips:
        print(f"{cell.name} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    # The program's host-side tensors are small: one thread keeps the
    # host's load to the loop's own.
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    line, notes, detail = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), device, t_start)
    print(json.dumps({"detail": detail}, default=float), file=sys.stderr)
    for n in notes:
        print(n, file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(json.dumps(line))
    return 0

