"""Where the time of one tape-backward optimisation step goes, on the card.

    python scripts/torch_profile_step.py [--traversal quad|pallas] [--no-remat]

Drives `dpt_tpu_torch` only, at the flagship configuration that
`chip_smoke.py` optimises (sylveon512 at 1024², the 65,024-triangle
procedural sphere, 4 bounces with SSS, 1 spp): a target rendered at albedo
0.8, the step taken from albedo 0.4.  After two warm-up steps it times, on
the host clock with the device synchronised, a taped forward
(`render_sample_taped`) and a whole `tape_loss_and_grads` (the backward is
their difference), takes the peak device memory of one step, and profiles
one more step with `torch.profiler`: device time by kernel family, kernels
run, launches made, and the device busy share of the profiled step.
`--no-remat` turns `cfg.remat_bounces` off.  Prints the card's
`nvidia-smi` name and power limit, then one JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch

# Run from anywhere in the checkout: the package sits one level up.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# Kernel families, matched in order against a lower-cased kernel name.
FAMILIES = (
    ("walk", ("quad_traverse", "wide_traverse")),
    ("brute-force search", ("intersect_nearest",)),
    ("sort", ("sort",)),
    ("index / gather / scatter", ("index", "gather", "scatter")),
    ("reduce", ("reduce",)),
    ("copy / fill", ("memcpy", "memset", "fill", "copy")),
    ("elementwise", ("elementwise", "vectorized")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--traversal", choices=["quad", "pallas"], default="quad")
    ap.add_argument("--no-remat", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.diff.grads import tape_loss_and_grads
    from dpt_tpu_torch.render.renderer import (
        render_sample,
        render_sample_taped,
    )
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    cfg = preset("sylveon512", width=1024, height=1024,
                 traversal=args.traversal, remat_bounces=not args.no_remat)
    scene = procedural_scene(66_000, device=dev)
    camera = OrbitCamera().camera(dev)
    accel = build_accel(scene, cfg)
    target = render_sample(scene, camera, cfg, 0, accel)
    start = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials,
        albedo=torch.full_like(scene.materials.albedo, 0.4)))

    def step():
        return tape_loss_and_grads(start, camera, cfg, target, 0, accel)

    for _ in range(2):
        timed(step)
    _, forward_ms = timed(
        lambda: render_sample_taped(start, camera, cfg, 0, accel))
    torch.cuda.reset_peak_memory_stats()
    _, step_ms = timed(step)
    peak = torch.cuda.max_memory_allocated()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, profiled_ms = timed(step)
    by_family = {}
    kernels_run = launches = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            fam = family(e.key)
            by_family[fam] = by_family.get(fam, 0.0) + (
                e.self_device_time_total / 1e3)
            kernels_run += e.count
        elif e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launches += e.count
    device_ms = sum(by_family.values())
    print(json.dumps({
        "traversal": args.traversal,
        "remat": not args.no_remat,
        "device": torch.cuda.get_device_name(0),
        "step_ms": step_ms,
        "taped_forward_ms": forward_ms,
        "backward_ms": step_ms - forward_ms,
        "peak_bytes": peak,
        "profiled_step_ms": profiled_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / profiled_ms,
        "device_ms_by_family": dict(sorted(by_family.items(),
                                           key=lambda kv: -kv[1])),
        "kernels_run": kernels_run,
        "launches": launches,
    }))


if __name__ == "__main__":
    main()
