"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python chip_smoke.py

Drives `dpt_tpu_torch` only (no JAX, no `dpt_tpu`), in five phases, each
printing one line:

  1. device  — a CUDA card of compute capability 9.0; prints
               `nvidia-smi --query-gpu=name,power.limit`.
  2. build   — compiles the kernels from csrc/ and prints the build time.
  3. kernel  — K1 (csrc/quad_traverse.cu) against its plain PyTorch walk on
               the card, at the flagship tables (65,024 triangles, SAH leaf
               8), on the 1024² primary stream and on 2**18 incoherent,
               coherence-sorted rays: hit / occluded / tri must be exact and
               t equal.  Median ms over 5 calls with varied inputs, CUDA
               events, after a warm-up.
  4. render  — the flagship forward render through the CLI
               (sylveon512 at 1024², 4 batches); the image must be finite,
               >= 0 and not all zero, the PNG valid, and K1 must have been
               launched 16 nearest + 16 occluded times per batch.
  5. devices — the same config at 64² on the card (kernel) and on the CPU
               (plain walk), allclose at rtol 1e-3, atol 2e-3.

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
SOURCE = "dpt_tpu_torch/csrc/quad_traverse.cu"
REPLACES = "dpt_tpu/kernels/pallas_quad.py:511"


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
    attrs = {m: build.kernel_attributes(m == "occluded")
             for m in ("nearest", "occluded")}
    print(f"[2 build] K1 built in {build.build_seconds:.2f} s "
          f"(load {wall:.2f} s); registers/local bytes per thread: "
          + ", ".join(f"{m} {a['num_regs']}/{a['local_bytes']}"
                      for m, a in attrs.items()), flush=True)


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


def compare_stream(name, inputs, accel, cfg):
    """Kernel vs plain walk on one stream; returns per-mode stats."""
    from dpt_tpu_torch.kernels import quad

    out = {}
    max_err = 0.0
    for o, d, md in inputs:
        kh, kt, ki = quad.quad_nearest(o, d, accel, cfg)
        ph, pt, pi = quad.quad_nearest_reference(o, d, accel, cfg)
        torch.cuda.synchronize()
        require(torch.equal(kh, ph), f"{name}: nearest hit differs")
        require(torch.equal(ki, pi), f"{name}: nearest tri differs")
        require(torch.equal(kt, pt), f"{name}: nearest t differs")
        max_err = max(max_err, float((kt - pt).abs().max()))
        ko = quad.quad_occluded(o, d, md, accel, cfg)
        po = quad.quad_occluded_reference(o, d, md, accel, cfg)
        require(torch.equal(ko, po), f"{name}: occluded differs")
    o, d, md = inputs[0]
    hit_frac = float(quad.quad_nearest(o, d, accel, cfg)[0].float().mean())
    occ_frac = float(quad.quad_occluded(o, d, md, accel, cfg).float().mean())
    out["nearest"] = {
        "ms": median_ms(lambda o, d, md: quad.quad_nearest(o, d, accel, cfg),
                        inputs),
        "plain_ms": median_ms(
            lambda o, d, md: quad.quad_nearest_reference(o, d, accel, cfg),
            inputs),
        "max_abs_err": max_err,
    }
    out["occluded"] = {
        "ms": median_ms(
            lambda o, d, md: quad.quad_occluded(o, d, md, accel, cfg), inputs),
        "plain_ms": median_ms(
            lambda o, d, md: quad.quad_occluded_reference(o, d, md, accel,
                                                          cfg),
            inputs),
        "max_abs_err": 0.0,
    }
    print(f"[3 kernel] {name}: R={o.shape[0]} hit {hit_frac:.4f} "
          f"occluded {occ_frac:.4f}; exact on {len(inputs)} inputs; "
          f"nearest {out['nearest']['ms']:.3f} ms "
          f"(plain {out['nearest']['plain_ms']:.3f}), occluded "
          f"{out['occluded']['ms']:.3f} ms "
          f"(plain {out['occluded']['plain_ms']:.3f})", flush=True)
    return out


def phase_kernel(device):
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.config import preset
    from dpt_tpu_torch.kernels.quad import launch_counts
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    cfg = preset("sylveon512", width=1024, height=1024)
    scene = procedural_scene(FLAGSHIP_TRIS_TARGET, device=device)
    require(scene.n_triangles == FLAGSHIP_TRIS,
            f"flagship mesh has {scene.n_triangles} triangles")
    t0 = time.perf_counter()
    accel = build_accel(scene, cfg)
    build_s = time.perf_counter() - t0
    print(f"[3 kernel] tables: {scene.n_triangles} tris, SAH leaf 8 build+pack "
          f"{build_s:.2f} s, W={accel.n_wide} records, "
          f"L={accel.tris.shape[0]} leaf rows, quad depth {accel.max_depth}",
          flush=True)
    camera = OrbitCamera().camera(device)
    prim = [primary_rays(camera, cfg, b, 100 + b, device)
            for b in range(TIMED_CALLS)]
    inco = [incoherent_rays(scene, INCOHERENT_RAYS, 200 + k, device)
            for k in range(TIMED_CALLS)]
    before = dict(launch_counts)
    stats = {"primary": compare_stream("primary 1024^2", prim, accel, cfg),
             "incoherent": compare_stream("incoherent 2^18", inco, accel, cfg)}
    require(launch_counts != before, "phase 3 never launched K1")
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
    print("[4 render] sylveon512 1024^2 x4 batches, 65,024 tris, 4 bounces: "
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
    print(f"[5 devices] 64^2 cuda vs cpu: max |diff| {float(diff.max()):.3g}, "
          f"{int(bad.any(-1).sum())} of {64 * 64} pixels outside "
          "rtol 1e-3 / atol 2e-3", flush=True)
    require(not bool(bad.any()), "cuda and cpu images differ")


def main():
    phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    stats = phase_kernel(device)
    with tempfile.TemporaryDirectory() as tmp:
        counts, _ = phase_render(tmp)
    phase_devices(device)

    kernels = []
    for mode in ("nearest", "occluded"):
        p, q = stats["primary"][mode], stats["incoherent"][mode]
        kernels.append({
            "name": f"quad_traverse<{mode}>",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            "launches": counts[mode],
            "max_abs_err": max(p["max_abs_err"], q["max_abs_err"]),
            "ms": p["ms"],
            "plain_ms": p["plain_ms"],
            "ms_incoherent": q["ms"],
            "plain_ms_incoherent": q["plain_ms"],
        })
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
