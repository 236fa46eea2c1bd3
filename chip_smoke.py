"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python chip_smoke.py

Drives `dpt_tpu_torch` only (no JAX, no `dpt_tpu`), in eight phases, each
printing one line or more:

  1. device   — a CUDA card of compute capability 9.0; prints
                `nvidia-smi --query-gpu=name,power.limit`.
  2. build    — compiles the kernels from csrc/ (one nvcc per source, all
                at once) and prints the build time and each kernel's
                registers and local bytes per thread.
  3. K1       — csrc/quad_traverse.cu against its plain PyTorch walk on the
                card, at the flagship tables (65,024 triangles, SAH leaf 8,
                packed 4-wide), on the 1024² primary stream and on 2**18
                incoherent, coherence-sorted rays: hit / occluded / tri
                exact and t equal.  Median ms over 5 calls with varied
                inputs, CUDA events, after a warm-up; the bound from the
                node visits and triangle tests these inputs need.
  4. K2       — csrc/wide_traverse.cu the same way, at the same tree packed
                paired-children (`traversal="pallas"`).
  5. render   — the flagship forward render through the CLI (sylveon512 at
                1024², 4 batches); the image must be finite, >= 0 and not
                all zero, the PNG valid, and K1 launched 16 nearest + 16
                occluded times per batch.
  6. devices  — the same config at 64² on the card (kernel) and on the CPU
                (plain walk), allclose at rtol 1e-3, atol 2e-3.
  7. optimize — inverse rendering through the CLI at 1024²: a target
                rendered with `render --out target.npy`, then 3 tape-backward
                steps from albedo 0.4, first with `quad` (albedo and
                vertices, refit every step), then with `pallas` (albedo and
                light intensity).  Finite losses, the albedo moves toward
                the target's (quad) and the loss falls (pallas); the walk is
                launched 16 + 16 times in each taped forward and never in a
                backward; refit_quad with unchanged vertices is pack_quad
                bit for bit.  Prints step_ms and peak device memory.
  8. grads    — tape_loss_and_grads at 64² on the card (kernels) against
                the CPU (plain walks), quad and pallas: loss at rtol 1e-5,
                every gradient at rtol 1e-3 / atol 1e-4 x max|g| (the CPU
                tests' tolerance).

Then one JSON line with the kernels, and as the last line
`{"ok": true, "device": {...}}`.  Any failed phase raises, and the script
exits non-zero without that last line.  Without a CUDA card it exits
non-zero at phase 1.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Full float32 everywhere: no TF32 in matrix products or convolutions (the
# port uses neither today; this keeps any later use exact-comparable).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# bench.py's default --tris: the procedural sphere then has 65,024 triangles.
FLAGSHIP_TRIS_TARGET = 66_000
FLAGSHIP_TRIS = 65_024
INCOHERENT_RAYS = 1 << 18
TIMED_CALLS = 5
# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s and non-tensor-core float32 FLOP/s.  The float32 peak counts an
# FMA as two operations; the walks are built with -fmad=false and issue no
# FMA, so each of their operations takes a whole instruction slot and they
# run at most at half the peak: 33.5e12 operations/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_F32_UNFUSED_OPS_PER_S = PEAK_F32_FLOP_PER_S / 2
# Float operations of one slab test (6 sub, 6 mul, 10 min/max, 3 compares)
# and of one Möller–Trumbore test (54: two cross products, four dot
# products, the determinant test, one reciprocal, seven compares), as the
# kernels spell them out (csrc/traverse_common.cuh).  Each is counted at
# the add / mul rate, which min / max, compares and the reciprocal do not
# exceed, so the bound stays a least time.
FLOPS_PER_SLAB = 25
FLOPS_PER_TRI_TEST = 54
# kernel -> (source, the TPU kernel it replaces, slabs per record visited)
KERNELS = {
    "quad_traverse": ("dpt_tpu_torch/csrc/quad_traverse.cu",
                      "dpt_tpu/kernels/pallas_quad.py:511", 4),
    "wide_traverse": ("dpt_tpu_torch/csrc/wide_traverse.cu",
                      "dpt_tpu/kernels/pallas_wide.py:209", 2),
}
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_device():
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"compute capability {cap}, need (9, 0)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[1 device] {torch.cuda.get_device_name(0)}, capability {cap}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)


def phase_build():
    from dpt_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    wall = time.perf_counter() - t0
    attrs = {(k, m): build.kernel_attributes(k, m == "occluded")
             for k in build.KERNELS for m in ("nearest", "occluded")}
    print(f"[2 build] {len(build.KERNELS)} kernels built in "
          f"{build.build_seconds:.2f} s (load {wall:.2f} s); registers/local "
          "bytes per thread: "
          + ", ".join(f"{k}<{m}> {a['num_regs']}/{a['local_bytes']}"
                      for (k, m), a in attrs.items()), flush=True)
    return attrs


def incoherent_rays(scene, n, seed, device):
    """Rays leaving random points of the mesh (offset off the surface) in
    uniform random directions, coherence-sorted as the bounce queries are."""
    from dpt_tpu_torch.render.compaction import sort_permutation

    rng = np.random.default_rng(seed)
    v0, v1, v2 = (x.cpu().numpy() for x in scene.tri_vertices())
    tid = rng.integers(0, v0.shape[0], n)
    r1, r2 = rng.random(n), rng.random(n)
    s = np.sqrt(r1)
    a, b = 1.0 - s, s * (1.0 - r2)
    p = v0[tid] + a[:, None] * (v1[tid] - v0[tid]) + b[:, None] * (
        v2[tid] - v0[tid])
    nrm = np.cross(v1[tid] - v0[tid], v2[tid] - v0[tid])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    side = np.where(rng.random(n) < 0.5, 1.0, -1.0)[:, None]
    o = (p + side * 1e-3 * nrm).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    md = rng.uniform(-0.25, 2.0, n).astype(np.float32)
    o, d, md = (torch.as_tensor(x, device=device) for x in (o, d, md))
    bmin = scene.vertices.min(dim=0).values.to(device)
    bmax = scene.vertices.max(dim=0).values.to(device)
    perm = sort_permutation(o, d, md > 0, bmin, bmax)
    return o[perm].contiguous(), d[perm].contiguous(), md[perm].contiguous()


def primary_rays(camera, cfg, sample_batch, seed, device):
    from dpt_tpu_torch.render.raygen import generate_rays

    o, d, _ = generate_rays(camera, cfg, sample_batch)
    rng = np.random.default_rng(seed)
    md = torch.as_tensor(rng.uniform(0.5, 6.0, o.shape[0]).astype(np.float32),
                         device=device)
    return o, d, md


def median_ms(fn, inputs):
    """Median over `inputs` of one call each, timed with CUDA events after
    one warm-up call."""
    fn(*inputs[0])
    torch.cuda.synchronize()
    times = []
    for args in inputs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def walk_module(kernel):
    """The wrapper module of one walk kernel: kernels/quad.py (K1) or
    kernels/wide.py (K2)."""
    if kernel == "quad_traverse":
        from dpt_tpu_torch.kernels import quad

        return quad
    from dpt_tpu_torch.kernels import wide

    return wide


def walk_functions(kernel):
    """(nearest, occluded, nearest_reference, occluded_reference) of one
    walk kernel."""
    m = walk_module(kernel)
    p = "quad" if kernel == "quad_traverse" else "wide"
    return tuple(getattr(m, f"{p}_{f}") for f in (
        "nearest", "occluded", "nearest_reference", "occluded_reference"))


def table_bytes(accel):
    nodes = accel.nodes_flat if hasattr(accel, "nodes_flat") else accel.nodes
    return 4 * (nodes.numel() + accel.tris.numel())


def bound(kernel, occluded, n_rays, stats, accel):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    (rays in, results out, both tables read once) over the HBM rate, and
    the float operations these rays' walks need (records visited x slabs,
    triangle tests) over the float32 rate of unfused operations."""
    rays_in = (28 if occluded else 24) * n_rays
    out = (4 if occluded else 8) * n_rays
    nbytes = rays_in + out + table_bytes(accel)
    flops = (stats["node_visits"] * KERNELS[kernel][2] * FLOPS_PER_SLAB
             + stats["tri_tests"] * FLOPS_PER_TRI_TEST)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_UNFUSED_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare_stream(kernel, name, inputs, accel, cfg, tag):
    """Kernel vs plain walk on one stream; returns per-mode stats."""
    nearest, occluded, nearest_ref, occluded_ref = walk_functions(kernel)
    out = {}
    max_err = 0.0
    stats = {"nearest": {}, "occluded": {}}
    for i, (o, d, md) in enumerate(inputs):
        kh, kt, ki = nearest(o, d, accel, cfg)
        ph, pt, pi = nearest_ref(o, d, accel, cfg,
                                 stats=stats["nearest"] if i == 0 else None)
        torch.cuda.synchronize()
        require(torch.equal(kh, ph), f"{kernel} {name}: nearest hit differs")
        require(torch.equal(ki, pi), f"{kernel} {name}: nearest tri differs")
        require(torch.equal(kt, pt), f"{kernel} {name}: nearest t differs")
        max_err = max(max_err, float((kt - pt).abs().max()))
        ko = occluded(o, d, md, accel, cfg)
        po = occluded_ref(o, d, md, accel, cfg,
                          stats=stats["occluded"] if i == 0 else None)
        require(torch.equal(ko, po), f"{kernel} {name}: occluded differs")
    o, d, md = inputs[0]
    hit_frac = float(nearest(o, d, accel, cfg)[0].float().mean())
    occ_frac = float(occluded(o, d, md, accel, cfg).float().mean())
    calls = {
        "nearest": [lambda o, d, md, f=f: f(o, d, accel, cfg)
                    for f in (nearest, nearest_ref)],
        "occluded": [lambda o, d, md, f=f: f(o, d, md, accel, cfg)
                     for f in (occluded, occluded_ref)],
    }
    for mode, (run, run_ref) in calls.items():
        bms, by = bound(kernel, mode == "occluded", o.shape[0], stats[mode],
                        accel)
        out[mode] = {
            "ms": median_ms(run, inputs),
            "plain_ms": median_ms(run_ref, inputs),
            "max_abs_err": max_err if mode == "nearest" else 0.0,
            "bound_ms": bms,
            "bound_by": by,
            **stats[mode],
        }
    n, q = out["nearest"], out["occluded"]
    print(f"[{tag}] {name}: R={o.shape[0]} hit {hit_frac:.4f} occluded "
          f"{occ_frac:.4f}; exact on {len(inputs)} inputs; nearest "
          f"{n['ms']:.3f} ms (plain {n['plain_ms']:.3f}, bound "
          f"{n['bound_ms']:.4f} by {n['bound_by']}; "
          f"{n['node_visits']} visits, {n['tri_tests']} tri tests), "
          f"occluded {q['ms']:.3f} ms (plain {q['plain_ms']:.3f}, bound "
          f"{q['bound_ms']:.4f} by {q['bound_by']}; {q['node_visits']} "
          f"visits, {q['tri_tests']} tri tests)", flush=True)
    return out


def phase_kernel(device, traversal, kernel, tag):
    """One walk kernel against its plain walk at the flagship tables."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    cfg = preset("sylveon512", width=1024, height=1024, traversal=traversal)
    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device=device)
    require(scene.n_triangles == FLAGSHIP_TRIS,
            f"flagship mesh has {scene.n_triangles} triangles")
    t0 = time.perf_counter()
    accel = build_accel(scene, cfg)
    build_s = time.perf_counter() - t0
    print(f"[{tag}] tables: {scene.n_triangles} tris, SAH leaf 8 build+pack "
          f"{build_s:.2f} s, {type(accel).__name__} "
          f"{table_bytes(accel)} bytes, L={accel.tris.shape[0]} leaf rows, "
          f"depth {accel.max_depth}", flush=True)
    camera = OrbitCamera().camera(device)
    prim = [primary_rays(camera, cfg, b, 100 + b, device)
            for b in range(TIMED_CALLS)]
    inco = [incoherent_rays(scene, INCOHERENT_RAYS, 200 + k, device)
            for k in range(TIMED_CALLS)]
    counts = walk_module(kernel).launch_counts
    before = dict(counts)
    stats = {"primary": compare_stream(kernel, "primary 1024^2", prim, accel,
                                       cfg, tag),
             "incoherent": compare_stream(kernel, "incoherent 2^18", inco,
                                          accel, cfg, tag)}
    require(counts != before, f"phase {tag} never launched {kernel}")
    return stats


def phase_render(tmp):
    from dpt_tpu_torch import cli
    from dpt_tpu_torch.kernels.quad import launch_counts, reset_launch_counts

    png = os.path.join(tmp, "flagship.png")
    metrics = os.path.join(tmp, "flagship.jsonl")
    batches = 4
    argv = ["render", "--preset", "sylveon512",
            "--procedural-tris", str(FLAGSHIP_TRIS_TARGET), "--width", "1024",
            "--height", "1024", "--batches", str(batches), "--out", png,
            "--metrics", metrics]
    reset_launch_counts()
    img = cli.main(argv)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    require(img.is_cuda and tuple(img.shape) == (1024, 1024, 3),
            f"image {tuple(img.shape)} on {img.device}")
    require(bool(torch.isfinite(img).all()), "image has non-finite values")
    require(bool((img >= 0).all()), "image has negative values")
    require(float(img.max()) > 0.0, "image is all zero")
    with open(png, "rb") as f:
        require(f.read(8) == b"\x89PNG\r\n\x1a\n", "PNG magic missing")
    want = {"nearest": 16 * batches, "occluded": 16 * batches}
    require(counts == want, f"K1 launches {counts}, want {want}")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    require(len(rows) == batches, f"{len(rows)} metrics rows")
    print("[5 render] sylveon512 1024^2 x4 batches, 65,024 tris, 4 bounces: "
          f"K1 launches {counts}; batch_ms "
          + ", ".join(f"{r['batch_ms']:.1f}" for r in rows)
          + "; gross rays/s "
          + ", ".join(f"{r['rays_per_s']:.4g}" for r in rows), flush=True)
    return counts, rows


def phase_devices(device):
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.render.renderer import render_sample
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    cfg = preset("sylveon512", width=64, height=64)
    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device="cpu")
    accel = build_accel(scene, cfg)
    camera = OrbitCamera().camera("cpu")
    img_cpu = render_sample(scene, camera, cfg, 0, accel)
    img_gpu = render_sample(scene.to(device), camera.to(device), cfg, 0,
                            accel.to(device)).cpu()
    diff = (img_gpu - img_cpu).abs()
    bad = ~torch.isclose(img_gpu, img_cpu, rtol=1e-3, atol=2e-3)
    print(f"[6 devices] 64^2 cuda vs cpu: max |diff| {float(diff.max()):.3g}, "
          f"{int(bad.any(-1).sum())} of {64 * 64} pixels outside "
          "rtol 1e-3 / atol 2e-3", flush=True)
    require(not bool(bad.any()), "cuda and cpu images differ")


def _flagship_args(traversal):
    return ["--preset", "sylveon512", "--procedural-tris",
            str(FLAGSHIP_TRIS_TARGET), "--width", "1024", "--height", "1024",
            "--traversal", traversal]


def same_values(a, b):
    """Equal as np.testing.assert_array_equal has it: NaN matches NaN and
    0.0 matches -0.0 (a min over tied signed zeros may keep either)."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_refit(device):
    """refit_quad on the card with unchanged vertices reproduces pack_quad
    exactly (as the JAX package's test_refit_identity compares)."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.kernels.quad import refit_quad
    from dpt_tpu_torch.scene.builder import procedural_scene

    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device=device)
    accel = build_accel(scene, preset("sylveon512"))
    same = refit_quad(accel, scene.vertices, scene.indices)
    require(same_values(same.nodes_flat, accel.nodes_flat)
            and same_values(same.tris, accel.tris),
            "refit_quad with unchanged vertices differs from pack_quad")
    print(f"[7 optimize] refit_quad on the card with unchanged vertices "
          f"equals pack_quad ({accel.n_wide} records, "
          f"{accel.tris.shape[0]} leaf rows)", flush=True)


def phase_optimize(tmp, traversal, opt_params):
    """`optimize` through the CLI at 1024², 3 tape-backward steps; returns
    (launch counts of the run, metrics rows)."""
    from dpt_tpu_torch import cli
    from dpt_tpu_torch.diff import grads

    kernel = "quad_traverse" if traversal == "quad" else "wide_traverse"
    mod = walk_module(kernel)
    target = os.path.join(tmp, f"target_{traversal}.npy")
    metrics = os.path.join(tmp, f"opt_{traversal}.jsonl")
    cli.main(["render", *_flagship_args(traversal), "--batches", "1",
              "--out", target, "--metrics", metrics])

    # Launches and ms of each taped forward and of each backward (the
    # playback render and its autograd pass), counted and timed around the
    # two functions the tape's autograd.Function calls.
    per_call = {"forward": [], "backward": []}
    ms = {"forward": [], "backward": []}

    def counted(fn, key):
        def wrapped(*a, **k):
            before = dict(mod.launch_counts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t0) * 1e3)
            per_call[key].append({m: mod.launch_counts[m] - before[m]
                                  for m in before})
            return out
        return wrapped

    saved = grads.render_sample_taped, grads._grad_of
    grads.render_sample_taped = counted(saved[0], "forward")
    grads._grad_of = counted(saved[1], "backward")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod.reset_launch_counts()
    try:
        params, losses = cli.main([
            "optimize", *_flagship_args(traversal), "--target", target,
            "--opt-params", opt_params, "--init-albedo", "0.4", "0.4", "0.4",
            "--fixed-seeds", "--steps", "3", "--backward", "tape",
            "--metrics", metrics,
            "--out", os.path.join(tmp, f"rec_{traversal}.npz")])
        torch.cuda.synchronize()
    finally:
        grads.render_sample_taped, grads._grad_of = saved
    counts = dict(mod.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    with open(metrics) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows = [r for r in rows if r["event"] == "opt_step"]

    steps = 3
    require(len(losses) == steps and np.isfinite(losses).all(),
            f"{traversal} optimize losses {losses}")
    require([r["step"] for r in rows] == list(range(steps)),
            f"{traversal} optimize metrics rows {rows}")
    want = {"nearest": 16, "occluded": 16}
    require(per_call["forward"] == [want] * steps,
            f"{kernel} launches per taped forward {per_call['forward']}")
    zero = {"nearest": 0, "occluded": 0}
    require(per_call["backward"] == [zero] * steps,
            f"{kernel} launches per backward {per_call['backward']}")
    require(counts == {m: 16 * steps for m in counts},
            f"{kernel} launches in the run {counts}")
    albedo = float(params["albedo"].mean())
    if traversal == "quad":
        require(abs(albedo - 0.8) < abs(0.4 - 0.8),
                f"mean albedo {albedo} did not move toward 0.8")
    else:
        require(losses[-1] < losses[0], f"pallas losses {losses} not falling")
    print(f"[7 optimize] {traversal} 1024^2, {opt_params}: losses "
          + ", ".join(f"{x:.6g}" for x in losses)
          + f"; mean albedo {albedo:.4f}; {kernel} launches {counts} "
          f"(16 + 16 per taped forward, 0 per backward); step_ms "
          + ", ".join(f"{r['step_ms']:.1f}" for r in rows)
          + " (taped forward " + ", ".join(f"{x:.1f}" for x in ms["forward"])
          + "; backward " + ", ".join(f"{x:.1f}" for x in ms["backward"])
          + f"); peak device memory {peak / 2**30:.3f} GiB", flush=True)
    return counts, rows, peak


def phase_grads(device):
    """Tape gradients at 64² on the card against the CPU, quad and
    pallas."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.diff.grads import PARAM_KEYS, tape_loss_and_grads
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device="cpu")
    camera = OrbitCamera().camera("cpu")
    rng = np.random.default_rng(5)
    target = torch.as_tensor(rng.uniform(0.0, 0.2, (64, 64, 3)).astype(
        np.float32))
    for traversal in ("quad", "pallas"):
        cfg = preset("sylveon512", width=64, height=64, traversal=traversal)
        accel = build_accel(scene, cfg)
        l_cpu, g_cpu = tape_loss_and_grads(scene, camera, cfg, target,
                                           sample_batch=0, accel=accel)
        l_gpu, g_gpu = tape_loss_and_grads(
            scene.to(device), camera.to(device), cfg, target.to(device),
            sample_batch=0, accel=accel.to(device))
        rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
        require(rel <= 1e-5, f"{traversal}: loss {float(l_gpu)} on the card, "
                f"{float(l_cpu)} on the CPU")
        worst = 0.0
        for k in PARAM_KEYS:
            a, b = g_gpu[k].cpu(), g_cpu[k]
            scale = max(float(b.abs().max()), 1e-12)
            ok = torch.isclose(a, b, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * scale)
            require(bool(ok.all()), f"{traversal}: gradient {k} differs "
                    f"(max |diff| {float((a - b).abs().max()):.3g})")
            worst = max(worst, float((a - b).abs().max()) / scale)
        print(f"[8 grads] {traversal} 64^2 tape on the card vs the CPU: loss "
              f"rel diff {rel:.3g}; worst gradient |diff| / max|g| "
              f"{worst:.3g} (within rtol {GRAD_RTOL}, atol {GRAD_ATOL_REL} x "
              "max|g|)", flush=True)


def kernel_entries(kernel, stats, launches, **extra):
    source, replaces, _ = KERNELS[kernel]
    out = []
    for mode in ("nearest", "occluded"):
        p, q = stats["primary"][mode], stats["incoherent"][mode]
        out.append({
            "name": f"{kernel}<{mode}>",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[mode],
            "max_abs_err": max(p["max_abs_err"], q["max_abs_err"]),
            "ms": p["ms"],
            "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"],
            "bound_by": p["bound_by"],
            "library_ms": None,
            "ms_incoherent": q["ms"],
            "plain_ms_incoherent": q["plain_ms"],
            "bound_ms_incoherent": q["bound_ms"],
            "bound_by_incoherent": q["bound_by"],
            **{k: v[mode] for k, v in extra.items()},
        })
    return out


def main():
    phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    k1 = phase_kernel(device, "quad", "quad_traverse", "3 K1")
    k2 = phase_kernel(device, "pallas", "wide_traverse", "4 K2")
    with tempfile.TemporaryDirectory() as tmp:
        render_counts, _ = phase_render(tmp)
        phase_devices(device)
        check_refit(device)
        quad_counts, _, _ = phase_optimize(tmp, "quad", "albedo,vertices")
        wide_counts, _, _ = phase_optimize(tmp, "pallas",
                                           "albedo,light_intensity")
    phase_grads(device)

    # No PyTorch call computes a BVH walk, so library_ms is null.
    kernels = (kernel_entries("quad_traverse", k1, render_counts,
                              launches_optimize=quad_counts)
               + kernel_entries("wide_traverse", k2, wide_counts))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
