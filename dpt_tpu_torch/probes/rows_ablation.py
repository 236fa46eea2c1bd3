"""P4-d's row-block kernel (`rows_kernel`, csrc/probes/crossbar.cu) across
builds of its source, timed in one process on one card.

    python -m dpt_tpu_torch.probes.rows_ablation [--variant NAME=DIR ...]
        [--rounds 3]

Each DIR is a copy of csrc/probes (its crossbar.cu, with the headers it
includes at their relative paths: probe_common.cuh and
../traverse_common.cuh); the package's own csrc/probes is always timed, as
"tree".  Each crossbar.cu is built alone by `kernels/build.build` (the
probe library's flags) into `_build/libdpt_rows_<name>_<hash>.so` and
bound to its `dpt_probe_crossbar_rows` (the same C interface in every
build).  On `probe_crossbar`'s inputs (seed 0) at 2,000 rows (the TPU
probe's) and at 2,003, every build is first checked equal to the plain
version bit for bit, then its kernel timed with `probes.launch_ms` (20
launches behind a sleep, the median), the builds in turns and their order
reversed every round.  Prints the card's name and power limit, a line per
build, row count and round, and one JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import sys

import numpy as np
import torch

from dpt_tpu_torch import probes
from dpt_tpu_torch.kernels import build
from dpt_tpu_torch.probes import probe_crossbar as p4

ROW_COUNTS = (2000, 2003)


def bind(name, probe_dir: pathlib.Path):
    """The `dpt_probe_crossbar_rows` of `probe_dir`'s crossbar.cu."""
    sources = [probe_dir / "crossbar.cu", probe_dir / "probe_common.cuh",
               probe_dir.parent / "traverse_common.cuh"]
    lib = ctypes.CDLL(str(build.build(f"libdpt_rows_{name}", sources)))
    fn = lib.dpt_probe_crossbar_rows
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, i, p, p]
    fn.restype = i
    return fn


def call(fn, tab, rows):
    out = torch.empty((p4.ROWS, p4.LANES), dtype=torch.float32,
                      device=tab.device)
    err = fn(tab.data_ptr(), tab.shape[0], rows.data_ptr(), rows.shape[0],
             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = probes.card_line()
    print(card, flush=True)
    dirs = {"tree": build.PROBE_CSRC}
    for v in args.variant:
        name, _, d = v.partition("=")
        dirs[name] = pathlib.Path(d).resolve()
    fns = {name: bind(name, d) for name, d in dirs.items()}
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    a = p4.inputs(rng, iters=max(ROW_COUNTS))
    tab = torch.as_tensor(a["tab"], device=dev)
    rows_of = {n: torch.as_tensor(a["rows"][:n], device=dev)
               for n in ROW_COUNTS}
    for n, rows in rows_of.items():
        plain = p4.row_blocks_reference(tab, rows)
        for name, fn in fns.items():
            got = call(fn, tab, rows)
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise SystemExit(f"{name} at {n} rows differs from the plain "
                                 "version")
    print(f"exact: {list(fns)} at {list(ROW_COUNTS)} rows", flush=True)
    times = {(name, n): [] for name in fns for n in ROW_COUNTS}
    order = list(fns)
    for r in range(args.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            for n, rows in rows_of.items():
                ms = statistics.median(probes.launch_ms(
                    lambda fn=fns[name], rows=rows: call(fn, tab, rows),
                    [()]))
                times[name, n].append(ms)
                print(f"round {r} {name} {n} rows: {ms:.5f} ms "
                      f"({ms * 1e6 / n:.1f} ns a step)", flush=True)
    print(json.dumps({"probe": "rows_ablation", "card": card,
                      "device": torch.cuda.get_device_name(0),
                      "kernel_ms": {f"{name}@{n}": v
                                    for (name, n), v in times.items()}}))


if __name__ == "__main__":
    main()
