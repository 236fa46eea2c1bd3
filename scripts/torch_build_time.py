"""Time the two ways of building the port's CUDA kernels from csrc/.

    python scripts/torch_build_time.py [--reps 3]

"single":   one `nvcc -shared` over every csrc/*.cu (nvcc compiles the
            sources one after another, then links);
"parallel": `kernels/build.build()`, one nvcc per source started together,
            then one link.

Each build goes to a fresh temporary directory under dpt_tpu_torch/_build/,
so nothing is cached; the two alternate (single, parallel, parallel,
single, ...) so drift of the host's load falls on both.  Prints the card's
`nvidia-smi` name and power limit and one JSON line with every wall time in
seconds.  Needs nvcc; runs no kernel.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from dpt_tpu_torch.kernels import build  # noqa: E402


def single(out_dir: pathlib.Path) -> float:
    srcs = [str(p) for p in build._sources() if p.suffix == ".cu"]
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
           "-o", str(out_dir / "lib.so"), *srcs]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True)
    return time.perf_counter() - t0


def parallel(out_dir: pathlib.Path) -> float:
    saved = build.BUILD_DIR
    build.BUILD_DIR = out_dir
    try:
        build.build()
    finally:
        build.BUILD_DIR = saved
    return build.build_seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    times = {"single": [], "parallel": []}
    order = []
    for r in range(args.reps):
        order += ["single", "parallel"] if r % 2 == 0 else ["parallel",
                                                            "single"]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for way in order:
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
            fn = single if way == "single" else parallel
            times[way].append(fn(pathlib.Path(d)))
    print(json.dumps({"sources": [p.name for p in build._sources()],
                      "seconds": times}))


if __name__ == "__main__":
    main()
