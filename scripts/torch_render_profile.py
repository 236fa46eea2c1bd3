"""Pipelined against serial progressive rendering, and where the time of
one forward batch goes, on the card.

    python scripts/torch_render_profile.py [--batches 4] [--pairs 5]
        [--configs flagship,box512] [--variant auto|lane|group]

Two configurations:
  flagship: sylveon512 at 1024², the procedural sphere of 65,024
            triangles, SAH leaf 8, the quad walk (K1), 1 spp per batch;
  box512:   512², 4 bounces, SSS, Russian roulette, 16 spp per batch, the
            box, kernels="intersect" (K3).
Each renders `--batches` batches after one warm-up batch, in `--pairs`
pairs of runs whose order alternates (serial then pipelined, pipelined
then serial, ...), so that drift of the shared host falls on both loops:
  serial:    render_sample + accumulate, then torch.cuda.synchronize(),
             per batch (batch_ms from the dispatch to the synchronise);
  pipelined: `render_progressive` (batch_ms from its on_batch metrics).
Then one more serial batch of each runs under `torch.profiler`: device
time by kernel family (scripts/torch_profile_step.py's families), kernels
run, launches made, and the device busy share of the batch.  For the
flagship it also lists every K1 launch of that batch in order (mode, rays,
kernel ms, design) and splits K1's device time between its two designs
(one ray per lane above `kernels/quad.py` GROUP_MAX_RAYS rays, one per
group of four lanes at or below).  `--variant` forces K1's design in the
profiled batch (auto: the wrapper's pick).  `--pairs 0` skips the pairs.
Prints the card's `nvidia-smi` name and power limit, one line per run, and
one JSON line with every batch_ms, the wall ms per batch of each run
(dispatch of the first batch to the last batch complete, over the batch
count), the ratio pipelined / serial of each pair's wall ms per batch,
whether the two loops gave the same image bit for bit, and the profile.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from dpt_tpu_torch.accel.bvh import build_accel  # noqa: E402
from dpt_tpu_torch.config import preset  # noqa: E402
from dpt_tpu_torch.render.renderer import (  # noqa: E402
    accumulate,
    render_progressive,
    render_sample,
)
from dpt_tpu_torch.scene.builder import (  # noqa: E402
    cornell_box_scene,
    procedural_scene,
)
from dpt_tpu_torch.scene.camera import OrbitCamera  # noqa: E402
from torch_profile_step import family  # noqa: E402


def serial(scene, camera, cfg, accel, n):
    """(image, batch_ms list, wall ms) of the serial loop."""
    img = torch.zeros((cfg.height, cfg.width, 3), device=scene.device)
    times = []
    torch.cuda.synchronize()
    start = time.perf_counter()
    for b in range(n):
        t0 = time.perf_counter()
        img = accumulate(img, render_sample(scene, camera, cfg, b, accel), b,
                         cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return img, times, (time.perf_counter() - start) * 1e3


def pipelined(scene, camera, cfg, accel, n):
    """(image, batch_ms list, wall ms) of render_progressive."""
    rows = []
    torch.cuda.synchronize()
    start = time.perf_counter()
    img, _ = render_progressive(scene, camera, cfg, accel=accel, n_batches=n,
                                on_batch=lambda b, im, m: rows.append(m))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - start) * 1e3
    return img, [r["batch_ms"] for r in rows], wall


def k1_launches(prof, sizes):
    """Every K1 launch of a profiled run, in order: the wrapper's (mode,
    rays, design) beside the kernel's device ms, and K1's device ms and
    launches per design."""
    from torch.autograd import DeviceType

    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "quad_traverse_kernel" in e.name),
                 key=lambda e: e.time_range.start)
    if len(evs) != len(sizes):
        raise RuntimeError(f"{len(sizes)} K1 launches, the profiler saw "
                           f"{len(evs)}")
    rows = []
    split = {f"{d}_{k}": 0 for d in ("lane", "group")
             for k in ("ms", "launches")}
    for (mode, n, design), e in zip(sizes, evs):
        if ("<true" in e.name) != (mode == "occluded"):
            raise RuntimeError(f"launch order differs: {mode} vs {e.name}")
        ms = e.time_range.elapsed_us() / 1e3
        rows.append({"mode": mode, "rays": n, "kernel_ms": ms,
                     "design": design})
        split[f"{design}_ms"] += ms
        split[f"{design}_launches"] += 1
    return {"launches": rows, **split}


def profile_batch(scene, camera, cfg, accel, variant=None):
    """Device ms by family, kernels run, launches and busy share of one
    serial batch, and its K1 launches, in design `variant` (None: the
    wrapper's pick), when it walks the quad BVH."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dpt_tpu_torch.kernels import quad

    sizes = []
    launch = quad._launch

    def spy(origin, direction, max_dist, accel, occluded):
        n = int(origin.shape[0])
        design = variant or quad.walk_design(n)
        sizes.append(("occluded" if occluded else "nearest", n, design))
        return launch(origin, direction, max_dist, accel, occluded, design)

    quad._launch = spy
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # A first kernel, so that a launch the profiler misses at the
            # start of its window is not one of K1's.
            torch.ones(1, device=scene.device).add_(1)
            _, times, _ = serial(scene, camera, cfg, accel, 1)
    finally:
        quad._launch = launch
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
    out = {"batch_ms": times[0], "device_ms": device_ms,
           "device_busy_share": device_ms / times[0],
           "device_ms_by_family": dict(sorted(by_family.items(),
                                              key=lambda kv: -kv[1])),
           "kernels_run": kernels_run, "launches": launches}
    if sizes:
        out["k1"] = k1_launches(prof, sizes)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--configs", default="flagship,box512")
    ap.add_argument("--variant", default="auto",
                    choices=("auto", "lane", "group"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    camera = OrbitCamera().camera(dev)
    flag_cfg = preset("sylveon512", width=1024, height=1024)
    flag_scene = procedural_scene(66_000, device=dev)
    configs = {
        "flagship": (flag_scene, flag_cfg, build_accel(flag_scene, flag_cfg)),
        "box512": (cornell_box_scene(device=dev),
                   preset("box512", kernels="intersect"), None),
    }
    out = {}
    for name in args.configs.split(","):
        scene, cfg, accel = configs[name]
        # Warm-up: first launches, allocator, cuBLAS / library handles.
        render_sample(scene, camera, cfg, 0, accel)
        res = {"serial": [], "pipelined": [], "ratio": []}
        images = {}
        for pair in range(args.pairs):
            ways = ("serial", "pipelined")
            wall_of = {}
            for way in ways if pair % 2 == 0 else ways[::-1]:
                fn = serial if way == "serial" else pipelined
                img, times, wall = fn(scene, camera, cfg, accel, args.batches)
                images[way] = img
                wall_of[way] = wall / args.batches
                res[way].append({"batch_ms": times,
                                 "wall_ms_per_batch": wall_of[way]})
                print(f"{name} {way}: median batch_ms "
                      f"{statistics.median(times):.2f}, wall ms per batch "
                      f"{wall_of[way]:.2f}", flush=True)
            res["ratio"].append(wall_of["pipelined"] / wall_of["serial"])
        if args.pairs:
            res["median_ratio"] = statistics.median(res["ratio"])
            res["same_image"] = bool(torch.equal(images["serial"],
                                                 images["pipelined"]))
        res["profile"] = profile_batch(
            scene, camera, cfg, accel,
            None if args.variant == "auto" else args.variant)
        print(f"{name} profiled batch: {res['profile']}", flush=True)
        out[name] = res
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "batches": args.batches, "runs": out}))


if __name__ == "__main__":
    main()
