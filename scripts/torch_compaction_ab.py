"""Time the flagship forward batch of two trees of the port, in turns.

    python scripts/torch_compaction_ab.py --tree parent=DIR --tree change=.
        [--batches 5] [--rounds 2]

Each DIR holds a `dpt_tpu_torch/` package (this checkout, or an older
commit unpacked with `git archive` into a directory that .gitignore
lists).  The trees run in the order A, B, B, A (`--rounds` 2), each in a
fresh Python process that imports only that tree's package: it builds the
flagship (the procedural sphere of 65,024 triangles, sylveon512 at 1024²,
its default compact_frac), times the set-up (`build_accel`: the SAH build
and the 4-wide pack, on the host clock), renders one warm-up batch, then
`--batches` batches of `render_sample`, each timed on the host clock
around a synchronised call, and counts K1's launches in the last of them;
then one more batch under torch.cuda.set_sync_debug_mode("warn"), its
synchronising calls counted by file:line.  Prints the card's `nvidia-smi`
name and power limit, one JSON line per run, and a last JSON line with
every run.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

CHILD = r"""
import json, os, sys, time, warnings
sys.path.insert(0, sys.argv[1])
import torch
from dpt_tpu_torch.accel.bvh import build_accel
from dpt_tpu_torch.config import preset
from dpt_tpu_torch.kernels import quad
from dpt_tpu_torch.render.renderer import render_sample
from dpt_tpu_torch.scene.builder import procedural_scene
from dpt_tpu_torch.scene.camera import OrbitCamera

dev = torch.device("cuda", 0)
cfg = preset("sylveon512", width=1024, height=1024)
scene = procedural_scene(66_000, device=dev)
t0 = time.perf_counter()
accel = build_accel(scene, cfg)
torch.cuda.synchronize()
setup_ms = (time.perf_counter() - t0) * 1e3
camera = OrbitCamera().camera(dev)
render_sample(scene, camera, cfg, 0, accel)
torch.cuda.synchronize()
ms = []
for b in range(int(sys.argv[2])):
    quad.reset_launch_counts()
    t0 = time.perf_counter()
    render_sample(scene, camera, cfg, 1 + b, accel)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
k1 = dict(quad.launch_counts)
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        render_sample(scene, camera, cfg, 99, accel)
    finally:
        torch.cuda.set_sync_debug_mode("default")
sites = {}
for w in caught:
    if str(w.message).startswith("called a synchronizing"):
        where = f"{os.path.relpath(w.filename, sys.argv[1])}:{w.lineno}"
        sites[where] = sites.get(where, 0) + 1
print(json.dumps({"setup_ms": setup_ms, "batch_ms": ms,
                  "compact_frac": cfg.compact_frac,
                  "k1_launches": k1,
                  "sync_warnings": sites}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, twice")
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    trees = [t.split("=", 1) for t in args.tree]
    if len(trees) != 2 or any(len(t) != 2 for t in trees):
        ap.error("give --tree NAME=DIR twice")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for r in range(args.rounds):
        for name, path in (trees if r % 2 == 0 else trees[::-1]):
            out = subprocess.run(
                [sys.executable, "-c", CHILD, path, str(args.batches)],
                capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                sys.exit(f"{name} failed ({out.returncode}):\n"
                         f"{out.stdout[-3000:]}{out.stderr[-6000:]}")
            run = {"tree": name, **json.loads(out.stdout.splitlines()[-1])}
            print(json.dumps(run), flush=True)
            runs.append(run)
    print(json.dumps({"device": smi, "runs": runs}))


if __name__ == "__main__":
    main()
