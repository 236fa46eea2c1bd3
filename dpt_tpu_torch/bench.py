"""Benchmark harness: prints ONE JSON line with the headline metric.

Counterpart of the root `bench.py` (the JAX package's): the same flagship
recipe, flags, timing, accounting and JSON keys.  Headline: rays/sec at
1024², 4 bounces on the Sylveon-class stand-in mesh (65,024 triangles at
the default --tris), forward by default, forward + backward (the tape step)
with --grad.  "Rays" follows SURVEY §3.3's accounting: every BVH traversal
launched per pixel-sample (primary + shadow + SSS walks).  The line also
carries rays_per_s_net (only live lanes charged, through the per-depth live
fraction measured at 256²).

Usage:
    python -m dpt_tpu_torch.bench              # headline forward, on the card
    python -m dpt_tpu_torch.bench --grad       # tape step (forward + backward)
    python -m dpt_tpu_torch.bench --quick      # 256²
    python -m dpt_tpu_torch.bench --device cpu --width 16 --tris 300 --iters 1

Where the port departs from the JAX file:
  - `--device` (default cuda, as the CLI): without a card the run raises
    unless `--device cpu` asks for the plain PyTorch versions.
  - `kernel_mode` says what ran: on the card `CUDA sm_90a <library file>`,
    and only when K1 (kernels/quad.py) launched inside the timed window,
    else the run raises; `PLAIN-CPU` on the CPU.  A failed build or launch
    ends the run: there is no fallback.
  - `table_modes` (TPU memory placement in JAX) names the K1 designs the
    timed window launched (`lane`, `group`), or `plain` on the CPU.
  - `vs_baseline` is null: JAX's anchors are TPU artifacts.
  - No persistent compile cache and no trace annotation (`bench.py:127-134`,
    :163): the kernels build once per checkout, at their first launch,
    which comes before the timed window (the capacity probe, else the
    warm-up).
The timed window is the host clock between two `torch.cuda.synchronize()`
calls, as JAX's is between two `block_until_ready`s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

# The live-fraction diagnostic's resolution: a statistic of the framing,
# not of the benchmarked resolution.
LIVE_IN_RES = 256


def _flagship_cfg(side, iters):
    """The recipe of `bench.py:25-43`: 4-wide walk (K1), SAH leaf 8,
    per-query coherence sort, SSS, compaction capacity 0.125.  The tiling
    knobs packet_tile / interleave are kept for parity and have no effect
    here."""
    from dpt_tpu_torch.config import RenderConfig

    return RenderConfig(
        width=side, height=side, max_depth=4, spp=1,
        traversal="quad", bvh_builder="sah", bvh_leaf_size=8,
        packet_tile=4096, interleave=1, ray_sort=True,
        enable_sss=True, sample_batches=iters,
        compact_frac=0.125,
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(step, warm, steps, device):
    """Seconds per step over `steps` after one warm-up step(warm), which
    fills the caching allocator; and K1's launches per design inside the
    timed window."""
    from dpt_tpu_torch.kernels import quad

    step(warm)
    _sync(device)
    before = dict(quad.design_counts)
    t0 = time.perf_counter()
    for i in steps:
        step(i)
    _sync(device)
    step_s = (time.perf_counter() - t0) / len(steps)
    return step_s, {k: quad.design_counts[k] - before[k] for k in before}


def _bench_fwd(scene, camera, cfg, accel, n_iters):
    from dpt_tpu_torch.render.renderer import render_sample

    return _timed(lambda b: render_sample(scene, camera, cfg, b, accel),
                  0, [100 + i for i in range(n_iters)], scene.device)


def _bench_grad(scene, camera, cfg, accel, n_iters, replay=False):
    """Forward + backward step time.  Default: the tape (the forward
    records every traversal outcome, the backward differentiates the
    playback: no walk in the backward); --grad-replay: the backward renders
    again."""
    from dpt_tpu_torch.diff.grads import (
        replay_loss_and_grads,
        tape_loss_and_grads,
    )

    impl = replay_loss_and_grads if replay else tape_loss_and_grads
    target = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                         device=scene.device)

    def step(i):
        return impl(scene, camera, cfg, target, sample_batch=100 + i,
                    accel=accel)

    return _timed(step, 0, range(1, n_iters + 1), scene.device)


def kernel_mode(device, launched) -> str:
    """What ran: the CUDA build, proven by K1 launches in the timed window
    (`launched`: launches per design), or the plain versions on the CPU."""
    if device.type != "cuda":
        return "PLAIN-CPU"
    if not sum(launched.values()):
        raise RuntimeError("K1 launched no time in the timed window")
    from dpt_tpu_torch.kernels import build

    return f"CUDA sm_90a {build.library_path().name}"


def table_modes(device, launched) -> str:
    """The K1 designs the timed window launched, or `plain` on the CPU."""
    if device.type != "cuda":
        return "plain"
    return "/".join(d for d, n in launched.items() if n)


def _build_parser():
    ap = argparse.ArgumentParser(prog="python -m dpt_tpu_torch.bench")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--grad", action="store_true",
                    help="benchmark forward+backward instead of forward"
                         " (tape backward: the forward records traversal "
                         "outcomes, the backward plays them back without "
                         "kernels)")
    ap.add_argument("--grad-replay", action="store_true",
                    help="with --grad: use the replay backward (re-renders "
                         "in the backward) instead of the tape")
    ap.add_argument("--no-playback-remat", action="store_true",
                    help="with --grad: store the playback's bounce "
                         "activations instead of rematerialising them")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--tris", type=int, default=66_000)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--rr", action="store_true",
                    help="enable Russian roulette")
    ap.add_argument("--compact-frac", type=float, default=None,
                    help="override the carry-compaction capacity fraction "
                         "(default: derived from the scene's measured "
                         "primary-hit fraction, auto_compact_frac)")
    ap.add_argument("--scene-family", choices=["sphere", "knot"],
                    default="sphere",
                    help="Sylveon-class stand-in mesh family (knot = "
                         "self-shadowing torus knot)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    return ap


def main(argv=None):
    args = _build_parser().parse_args(argv)

    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.render.renderer import (
        auto_compact_frac,
        live_fraction_by_depth,
    )
    from dpt_tpu_torch.scene.builder import knot_scene, procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera
    from dpt_tpu_torch.scene.scene import resolve_device
    from dpt_tpu_torch.utils.metrics import (
        effective_traversals_per_sample,
        traversals_per_sample,
    )

    device = resolve_device(args.device)
    side = args.width or (256 if args.quick else 1024)
    cfg = _flagship_cfg(side, args.iters)
    if args.rr:
        cfg = cfg.replace(russian_roulette=True)
    if args.no_playback_remat:
        cfg = cfg.replace(playback_remat_bounces=False)
    family = knot_scene if args.scene_family == "knot" else procedural_scene
    scene = family(n_tris_target=args.tris, device=device)
    camera = OrbitCamera().camera(device)
    accel = build_accel(scene, cfg)
    if args.compact_frac is not None:
        cfg = cfg.replace(compact_frac=args.compact_frac)
    else:
        # One 256² primary-trace probe sizes the capacity to the scene's
        # live fraction (the sphere lands near 0.125, the knot higher).
        cfg = cfg.replace(
            compact_frac=auto_compact_frac(scene, camera, cfg, accel))

    if args.grad:
        step_s, launched = _bench_grad(scene, camera, cfg, accel, args.iters,
                                       replay=args.grad_replay)
    else:
        step_s, launched = _bench_fwd(scene, camera, cfg, accel, args.iters)
    mode = kernel_mode(device, launched)

    lf_cfg = cfg.replace(width=LIVE_IN_RES, height=LIVE_IN_RES)
    live_in = live_fraction_by_depth(scene, camera, lf_cfg, accel)
    gross = cfg.n_pixels * cfg.spp * traversals_per_sample(
        cfg, scene.lights.count)
    net = cfg.n_pixels * cfg.spp * effective_traversals_per_sample(
        cfg, scene.lights.count, live_in)

    value = gross / step_s
    print(json.dumps({
        "metric": f"rays/sec/chip {'fwd+bwd' if args.grad else 'fwd'} "
                  f"(gross) {side}x{side} 4bounce {scene.n_triangles}tris",
        "value": round(value, 1),
        "unit": "rays/s",
        "vs_baseline": None,
        "step_ms": round(step_s * 1e3, 2),
        "rays_per_s_net": round(net / step_s, 1),
        "live_in_by_depth": [round(f, 4) for f in live_in],
        "live_in_res": LIVE_IN_RES,
        "kernel_mode": mode,
        "table_modes": table_modes(device, launched),
        "config": "quad+sah8+ray_sort tile=4096 "
                  f"preshade-compact={cfg.compact_frac}"
                  + (" +rr" if args.rr else "")
                  + ((" bwd=replay" if args.grad_replay else " bwd=tape")
                     if args.grad else ""),
    }))


if __name__ == "__main__":
    sys.exit(main())
