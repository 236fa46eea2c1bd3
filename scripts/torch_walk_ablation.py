"""Kernel times of the BVH walks K1 and K2 across builds, designs and streams.

    python scripts/torch_walk_ablation.py [--variant NAME=CSRC_DIR ...]
        [--kernels quad_traverse,wide_traverse]
        [--streams primary:1024,incoherent:262144,incoherent:126621]
        [--inputs 5] [--rounds 2] [--reps 2]

Each `--variant` is a directory of kernel sources (`*.cu`, `*.cuh`), built
by `kernels/build.py` `build` (one `nvcc` a `.cu` file, with its flags)
into a library of its own under `dpt_tpu_torch/_build/`; with none, the
package's own `dpt_tpu_torch/csrc` is timed as "tree".  Each library is
bound by ctypes to its own C interface: the launches
`dpt_quad_traverse` and `dpt_wide_traverse` (the same arguments in every
build since the port began), and K1's one-ray-per-group-of-four-lanes
launch `dpt_quad_traverse_group` where the build exports it.  Every build
runs one ray per lane ("lane"), and K1 also one ray per group ("group")
where it can.

The streams run over `chip_smoke.py`'s flagship tables (65,024
triangles, SAH leaf 8) packed 4-wide (K1) and paired-children (K2):
`primary:RES` is the primary rays of a RES x RES image of the flagship
camera, `incoherent:N` is N rays leaving the mesh in uniform directions,
coherence-sorted (chip_smoke.incoherent_rays; 126,621 is the size of the
flagship render's queries after the primary, chip_smoke.BOUNCE_RAYS),
`--inputs` of each.  For each build, design, kernel, stream and mode the
script first checks that the kernel's results equal the plain walk's
exactly (t and tri, or occluded), then takes the kernel's mean device time
over the inputs x `--reps` from `torch.profiler`: the kernel alone, without
the wrapper.  The builds and designs run in turns, the order reversed every
round (a b, b a, ...), so that drift of the card falls on all of them.
Also prints each stream's lane utilisation of a one-thread-per-ray warp
(mean records visited over the mean of each 32 consecutive rays' maximum,
from the plain walk) and its bound (chip_smoke.bound).  Prints the card's
`nvidia-smi` name and power limit, one line per measurement, and one JSON
line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dpt_tpu_torch.kernels import build  # noqa: E402

KERNELS = {"quad_traverse": "quad", "wide_traverse": "pallas"}
MODES = ("nearest", "occluded")
# design -> the export of each kernel that walks in it
EXPORTS = {"lane": {"quad_traverse": "dpt_quad_traverse",
                    "wide_traverse": "dpt_wide_traverse"},
           "group": {"quad_traverse": "dpt_quad_traverse_group"}}


def build_library(csrc: pathlib.Path) -> ctypes.CDLL:
    """Compile every .cu of `csrc` into one library keyed by the sources
    (kernels/build.py `build`) and bind its walk launches."""
    lib = ctypes.CDLL(str(build.build(
        "libablation", sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")))))
    p, i = ctypes.c_void_p, ctypes.c_int
    for per_kernel in EXPORTS.values():
        for name in per_kernel.values():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = [p, p, p, p, p, i, i, p, p, p]
                getattr(lib, name).restype = i
    return lib


def attributes(lib, csrc, kernel, design):
    """Registers / local bytes (/ resident blocks per SM, where the build
    reports them) of both modes, from the attribute export of the design's
    launch, bound to the signature its source declares."""
    name = EXPORTS[design][kernel] + "_attrs"
    m = re.search(rf"{name}\(int occluded,([^)]*)\)",
                  (csrc / f"{kernel}.cu").read_text())
    if m is None or not hasattr(lib, name):
        return "not reported"
    n_out = m.group(1).count("int*")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int, *[ctypes.POINTER(ctypes.c_int)] * n_out]
    fn.restype = ctypes.c_int
    out = {}
    for mode in MODES:
        vals = [ctypes.c_int(0) for _ in range(n_out)]
        err = fn(int(mode == "occluded"), *(ctypes.byref(v) for v in vals))
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        out[mode] = [v.value for v in vals]
    return out


def run(lib, kernel, design, accel, o, d, md, mode):
    """One launch on the current stream: (t, tri or occluded) int32.  Both
    buffers and max_dist are always passed, as older builds expect."""
    nodes = accel.nodes_flat if kernel == "quad_traverse" else accel.nodes
    R = o.shape[0]
    out_t = torch.empty((R,), dtype=torch.float32, device=o.device)
    out_i = torch.empty((R,), dtype=torch.int32, device=o.device)
    err = getattr(lib, EXPORTS[design][kernel])(
        *(ctypes.c_void_p(x.data_ptr()) for x in (o, d, md, nodes,
                                                   accel.tris)),
        R, int(mode == "occluded"), ctypes.c_void_p(out_t.data_ptr()),
        ctypes.c_void_p(out_i.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"{kernel} ({design}) launch: cudaError {err}")
    return out_t, out_i


def make_stream(spec, scene, camera, n, dev):
    """The `n` inputs (o, d, max_dist) of one `--streams` entry."""
    from dpt_tpu_torch.config import preset

    kind, size = spec.split(":")
    size = int(size)
    if kind == "primary":
        cfg = preset("sylveon512", width=size, height=size)
        return [chip_smoke.primary_rays(camera, cfg, b, 100 + b, dev)
                for b in range(n)]
    if kind == "incoherent":
        return [chip_smoke.incoherent_rays(scene, size, 200 + k, dev)
                for k in range(n)]
    raise ValueError(f"unknown stream {spec!r}")


def stream_setup(kernel, specs, n_inputs):
    """(accel, {stream: (inputs, plain results, bound and utilisation)})."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    dev = torch.device("cuda", 0)
    cfg = preset("sylveon512", width=1024, height=1024,
                 traversal=KERNELS[kernel])
    scene = procedural_scene(chip_smoke.FLAGSHIP_TRIS_TARGET, device=dev)
    accel = build_accel(scene, cfg)
    camera = OrbitCamera().camera(dev)
    _, _, nearest_ref, occluded_ref = chip_smoke.walk_functions(kernel)
    out = {}
    for spec in specs:
        inputs = make_stream(spec, scene, camera, n_inputs, dev)
        plain, info = [], {}
        for i, (o, d, md) in enumerate(inputs):
            stats = {m: {} if i == 0 else None for m in MODES}
            _, pt, pi = nearest_ref(o, d, accel, cfg, stats=stats["nearest"])
            po = occluded_ref(o, d, md, accel, cfg, stats=stats["occluded"])
            plain.append((pt, pi, po))
            if i == 0:
                for m in MODES:
                    bms, by = chip_smoke.bound(kernel, m == "occluded",
                                               o.shape[0], stats[m], accel)
                    info[m] = {"rays": o.shape[0], "bound_ms": bms,
                               "bound_by": by,
                               "lane_utilisation": chip_smoke.lane_utilisation(
                                   stats[m]["ray_visits"])}
        out[spec] = (inputs, plain, info)
    return accel, out


def check_exact(lib, kernel, design, accel, inputs, plain, what):
    for (o, d, md), (pt, pi, po) in zip(inputs, plain):
        kt, ki = run(lib, kernel, design, accel, o, d, md, "nearest")
        _, ko = run(lib, kernel, design, accel, o, d, md, "occluded")
        torch.cuda.synchronize()
        if not (torch.equal(kt, pt) and torch.equal(ki, pi)
                and torch.equal(ko.bool(), po)):
            raise RuntimeError(f"{what}: differs from the plain walk")


def kernel_ms(lib, kernel, design, accel, inputs, reps):
    """Mean device ms of one launch per mode, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for mode in MODES:
        run(lib, kernel, design, accel, *inputs[0], mode)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        for _ in range(reps):
            for o, d, md in inputs:
                for mode in MODES:
                    run(lib, kernel, design, accel, o, d, md, mode)
        torch.cuda.synchronize()
    times = {m: [] for m in MODES}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and kernel in e.name:
            m = re.search(r"<(true|false)", e.name)
            mode = "occluded" if m and m.group(1) == "true" else "nearest"
            times[mode].append(e.time_range.elapsed_us() / 1e3)
    want = reps * len(inputs)
    for mode, ts in times.items():
        if len(ts) != want:
            raise RuntimeError(f"{kernel} {mode}: profiler saw {len(ts)} of "
                               f"{want} launches")
    return {m: statistics.fmean(ts) for m, ts in times.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=CSRC_DIR")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--streams",
                    default="primary:1024,incoherent:262144,incoherent:126621")
    ap.add_argument("--inputs", type=int, default=chip_smoke.TIMED_CALLS)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kernels = args.kernels.split(",")
    specs = [v.split("=", 1) for v in args.variant] or [["tree", build.CSRC]]
    libs, runs = {}, []
    for name, csrc in specs:
        csrc = ROOT / csrc
        libs[name] = build_library(csrc)
        for design, per_kernel in EXPORTS.items():
            for k in kernels:
                if k in per_kernel and hasattr(libs[name], per_kernel[k]):
                    runs.append((name, design, k))
                    print(f"{name}/{design} {k}: regs/local(/blocks per SM) "
                          + json.dumps(attributes(libs[name], csrc, k,
                                                  design)), flush=True)
    setups = {k: stream_setup(k, args.streams.split(","), args.inputs)
              for k in kernels}
    for kernel, (_, streams) in setups.items():
        for sname, (_, _, info) in streams.items():
            print(f"{kernel} {sname}: " + json.dumps(info), flush=True)
    res = {f"{v}/{g}": {} for v, g, _ in runs}
    for rnd in range(args.rounds):
        for vname, design, kernel in runs if rnd % 2 == 0 else runs[::-1]:
            accel, streams_of = setups[kernel]
            for sname, (inputs, plain, _) in streams_of.items():
                what = f"{vname}/{design} {kernel} {sname}"
                if rnd == 0:
                    check_exact(libs[vname], kernel, design, accel, inputs,
                                plain, what)
                ms = kernel_ms(libs[vname], kernel, design, accel, inputs,
                               args.reps)
                per = res[f"{vname}/{design}"].setdefault(
                    kernel, {}).setdefault(sname, {m: [] for m in MODES})
                for m in MODES:
                    per[m].append(ms[m])
                print(f"round {rnd} {what}: nearest {ms['nearest']:.4f} ms, "
                      f"occluded {ms['occluded']:.4f} ms", flush=True)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "streams": {k: {s: v[2] for s, v in st.items()}
                    for k, (_, st) in setups.items()},
        "kernel_ms": res}))


if __name__ == "__main__":
    main()
