"""Command-line entry point: the `render` and `optimize` subcommands.

Counterpart of those subcommands of `dpt_tpu/cli.py`:
    python -m dpt_tpu_torch.cli render --preset sylveon512 --out out.png
    python -m dpt_tpu_torch.cli render --device cpu --width 16 --height 16
    python -m dpt_tpu_torch.cli render --width 64 --height 64 --out t.npy
    python -m dpt_tpu_torch.cli optimize --width 64 --height 64 \\
        --target t.npy --opt-params albedo --init-albedo 0.4 0.4 0.4

The default device is `cuda`, and a command fails when no card is present;
the CPU runs only when asked for with `--device cpu`.  Options of the JAX
CLI that are not ported yet are accepted and exit with a "not yet ported"
error naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import hashlib
import sys

PRESET_NAMES = ["box256", "box512", "sylveon512", "sylveon1024",
                "sylveon2048"]

# option dest -> the ROADMAP item that ports it, per subcommand.
_NOT_PORTED_COMMON = {
    "sharded": "--sharded (ROADMAP Queue 1 item 4)",
    "coordinator": "--coordinator (ROADMAP Queue 1 item 4)",
    "wavefront_sort": "--wavefront-sort (ROADMAP Queue 1 item 5)",
    "scene": "--scene (ROADMAP Queue 1 item 7, the OBJ loader)",
}
_NOT_PORTED = {
    "render": {"checkpoint": "render --checkpoint (ROADMAP Queue 1 item 3)",
               **_NOT_PORTED_COMMON},
    "optimize": _NOT_PORTED_COMMON,
}

# RenderConfig fields that change what is rendered.  The checkpoint's config
# key hashes only these: the others (traversal, BVH build, packet_tile,
# ray_sort, compact_frac, the remat flags, ...) change how fast the same
# estimate is computed, and toggling one must not discard a valid resume.
_FRAMING_FIELDS = (
    "width", "height", "max_depth", "spp", "direct_light_view", "enable_sss",
    "sss_bounces", "russian_roulette", "rr_start_depth", "enable_dof",
    "aperture", "focal_distance", "aa_jitter", "uv_texture",
    "uv_texture_scale", "offset", "eps", "t_max",
)


def _positive_int(s):
    v = int(s)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer: {s!r}")
    return v


def _frac_or_auto(s):
    return "auto" if s == "auto" else float(s)


def _add_cfg_args(r):
    """Config, scene, camera and device arguments shared by both commands."""
    r.add_argument("--preset", choices=PRESET_NAMES)
    r.add_argument("--procedural-tris", type=_positive_int,
                   help="use the procedural Sylveon-class sphere with ~N "
                        "triangles instead of a preset's default scene")
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--bounces", type=int)
    r.add_argument("--spp", type=int)
    r.add_argument("--traversal", choices=["brute", "quad", "pallas"],
                   help="nearest/any-hit backend (quad = 4-wide BVH walk, "
                        "pallas = paired-children BVH walk)")
    r.add_argument("--bvh-builder", choices=["median", "sah"])
    r.add_argument("--leaf-size", type=_positive_int,
                   help="max triangles per BVH leaf")
    r.add_argument("--sort", action="store_true",
                   help="coherence-sort every query stream after the primary")
    r.add_argument("--no-sss", action="store_true")
    r.add_argument("--rr", action="store_true", help="Russian roulette")
    r.add_argument("--compact-frac", type=_frac_or_auto, default=None,
                   help="carry compaction after the primary trace "
                        "(> 0 on, 0 off; 'auto' is not ported yet)")
    r.add_argument("--metrics", help="JSONL metrics file (default stdout)")
    r.add_argument("--yaw", type=float, default=0.0)
    r.add_argument("--pitch", type=float, default=0.0)
    r.add_argument("--radius", type=float, default=5.0)
    r.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch walks)")
    # Accepted for command-line parity; not ported yet.
    r.add_argument("--sharded", action="store_true")
    r.add_argument("--coordinator")
    r.add_argument("--wavefront-sort", action="store_true")
    r.add_argument("--scene")


def _build_parser():
    p = argparse.ArgumentParser(prog="dpt_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene progressively")
    _add_cfg_args(r)
    r.add_argument("--batches", type=int, default=8)
    r.add_argument("--out", default="render.png",
                   help=".png (tonemapped) or .npy (raw radiance)")
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--checkpoint")

    o = sub.add_parser("optimize",
                       help="inverse rendering: recover scene parameters "
                            "from a target image")
    _add_cfg_args(o)
    o.add_argument("--target", required=True,
                   help="target image (.npy float radiance, e.g. from "
                        "`render --out target.npy`)")
    o.add_argument("--steps", type=_positive_int, default=16)
    o.add_argument("--lr", type=float, default=5e-2)
    o.add_argument("--optimizer", choices=["adam", "sgd"], default="adam")
    o.add_argument("--opt-params", default="albedo",
                   help="comma-separated parameters to optimise "
                        "(diff/optimize.OPTIMIZABLE)")
    o.add_argument("--micro-steps", type=_positive_int, default=1,
                   help="gradient-accumulation renders per step")
    o.add_argument("--backward", choices=["tape", "replay"], default="tape",
                   help="tape: the forward records traversal outcomes and "
                        "the backward plays them back (no traversal); "
                        "replay: the backward renders again")
    o.add_argument("--fixed-seeds", action="store_true",
                   help="reuse seeds 0..micro_steps-1 every step (right "
                        "when the target is one rendered batch)")
    o.add_argument("--init-albedo", type=float, nargs=3, default=None,
                   metavar=("R", "G", "B"),
                   help="start every material's albedo here")
    o.add_argument("--checkpoint",
                   help="npz params + optimizer-state checkpoint (resumed "
                        "if it exists and matches)")
    o.add_argument("--checkpoint-every", type=int, default=0)
    o.add_argument("--out", default="recovered.npz",
                   help="recovered parameters (npz)")
    return p


def _make_cfg(args):
    from dpt_tpu_torch.config import RenderConfig, preset

    cfg = preset(args.preset) if args.preset else RenderConfig(
        width=256, height=256, spp=1, max_depth=4, traversal="brute",
    )
    over = {}
    if args.width is not None:
        over["width"] = args.width
    if args.height is not None:
        over["height"] = args.height
    if args.bounces is not None:
        over["max_depth"] = args.bounces
    if args.spp is not None:
        over["spp"] = args.spp
    if args.traversal:
        over["traversal"] = args.traversal
    if args.bvh_builder:
        over["bvh_builder"] = args.bvh_builder
    if args.leaf_size is not None:
        over["bvh_leaf_size"] = args.leaf_size
    if args.sort:
        over["ray_sort"] = True
    if args.no_sss:
        over["enable_sss"] = False
    if args.rr:
        over["russian_roulette"] = True
    if args.compact_frac is not None:
        over["compact_frac"] = args.compact_frac
    return cfg.replace(**over) if over else cfg


def _pick_scene(args, device):
    """Explicit procedural triangle count > preset default (sylveon presets
    get the Sylveon-class procedural stand-in, everything else the box)."""
    from dpt_tpu_torch.scene.builder import cornell_box_scene, procedural_scene

    if args.procedural_tris:
        return procedural_scene(n_tris_target=args.procedural_tris,
                                device=device)
    if args.preset and args.preset.startswith("sylveon"):
        return procedural_scene(device=device)
    return cornell_box_scene(device=device)


def _setup(args, parser):
    """Refuse what is not ported, then (device, cfg, scene, orbit, camera,
    accel)."""
    import torch

    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.scene.camera import OrbitCamera
    from dpt_tpu_torch.scene.scene import NO_CUDA

    for dest, what in _NOT_PORTED[args.cmd].items():
        if getattr(args, dest):
            parser.error(f"{what} is not yet ported to dpt_tpu_torch")
    if args.compact_frac == "auto":
        parser.error("--compact-frac auto (ROADMAP Queue 1 item 3) is not "
                     "yet ported to dpt_tpu_torch")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(NO_CUDA)
    cfg = _make_cfg(args)
    scene = _pick_scene(args, device)
    orbit = OrbitCamera(yaw=args.yaw, pitch=args.pitch, radius=args.radius)
    return device, cfg, scene, orbit, orbit.camera(device), build_accel(
        scene, cfg)


def cmd_render(args, parser):
    """Render, write the image and one metrics line per batch; returns the
    image [H, W, 3] on the render device."""
    from dpt_tpu_torch.render.renderer import render_progressive
    from dpt_tpu_torch.utils.io import save_image
    from dpt_tpu_torch.utils.metrics import JsonlLogger

    device, cfg, scene, _, camera, accel = _setup(args, parser)
    logger = JsonlLogger(args.metrics)
    try:
        def on_batch(b, img, metrics):
            logger.log(event="batch", batch=b, device=str(device), **metrics)

        img, n_done = render_progressive(scene, camera, cfg, accel=accel,
                                         n_batches=args.batches,
                                         on_batch=on_batch)
    finally:
        logger.close()
    save_image(args.out, img.cpu().numpy(), exposure=args.exposure)
    print(f"wrote {args.out} ({n_done} batches)", file=sys.stderr)
    return img


def _checkpoint_meta(args, orbit, cfg, opt_keys):
    """Integrity meta of an optimisation checkpoint: the camera state plus a
    hash of the framing fields of cfg, the scene choice and the
    optimisation setup."""
    import numpy as np

    framing = {f: getattr(cfg, f) for f in _FRAMING_FIELDS}
    setup = (args.preset, args.procedural_tris, args.init_albedo,
             args.target, args.lr, args.optimizer, opt_keys,
             args.micro_steps, args.backward, args.fixed_seeds)
    key = hashlib.sha1(repr((sorted(framing.items()), setup)).encode())
    return {"camera_state": np.asarray(orbit.state_tuple(), np.float64),
            "config_key": key.hexdigest()}


def cmd_optimize(args, parser):
    """Inverse rendering: target image + starting scene -> optimisation
    steps with gradient accumulation, JSONL metrics and params + optimizer
    state checkpoint / resume.  Returns (params, losses)."""
    import dataclasses

    import numpy as np
    import torch

    from dpt_tpu_torch.diff.grads import split_params
    from dpt_tpu_torch.diff.optimize import (
        initial_opt_state,
        load_state,
        optimize,
        save_state,
    )
    from dpt_tpu_torch.utils.checkpoint import Checkpointer, meta_matches
    from dpt_tpu_torch.utils.metrics import JsonlLogger

    device, cfg, scene, orbit, camera, accel = _setup(args, parser)
    if args.init_albedo is not None:
        albedo = torch.tensor(args.init_albedo, dtype=torch.float32,
                              device=device).expand_as(scene.materials.albedo)
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, albedo=albedo.contiguous()))
    target = np.load(args.target).astype(np.float32)
    if target.shape != (cfg.height, cfg.width, 3):
        parser.error(f"target {target.shape} != render "
                     f"{(cfg.height, cfg.width, 3)}")
    target = torch.as_tensor(target, device=device)
    opt_keys = tuple(k.strip() for k in args.opt_params.split(",")
                     if k.strip())
    meta = _checkpoint_meta(args, orbit, cfg, opt_keys)

    ckpt = Checkpointer(args.checkpoint) if args.checkpoint else None
    start_step, init_params, init_opt = 0, None, None
    if ckpt is not None and ckpt.exists():
        loaded = ckpt.load()
        if loaded is not None and meta_matches(
                loaded[2]["meta"], meta["camera_state"], meta["config_key"]):
            params_t = split_params(scene, camera)
            restored = load_state(ckpt, params_t, initial_opt_state(
                args.optimizer, params_t, opt_keys))
            if restored is not None:
                start_step, init_params, init_opt = restored
                print(f"resuming from step {start_step}", file=sys.stderr)
        elif loaded is not None:
            print("checkpoint setup mismatch: starting fresh",
                  file=sys.stderr)

    logger = JsonlLogger(args.metrics)
    try:
        def on_step(step, loss, metrics):
            logger.log(event="opt_step", step=step, loss=loss,
                       device=str(device), **metrics)

        params, opt_state, losses = optimize(
            scene, camera, cfg, target,
            steps=max(args.steps, start_step), lr=args.lr,
            optimizer=args.optimizer, opt_params=opt_keys,
            micro_steps=args.micro_steps, accel=accel,
            backward=args.backward, checkpointer=ckpt,
            checkpoint_every=args.checkpoint_every, checkpoint_meta=meta,
            on_step=on_step, init_params=init_params,
            init_opt_state=init_opt, start_step=start_step,
            advance_seeds=not args.fixed_seeds,
        )
    finally:
        logger.close()
    if ckpt is not None:
        save_state(ckpt, max(args.steps, start_step), params, opt_state,
                   meta=meta)
    np.savez(args.out, **{k: v.detach().cpu().numpy()
                          for k, v in params.items()})
    print(f"wrote {args.out} (final loss "
          f"{losses[-1] if losses else float('nan'):.6g})", file=sys.stderr)
    return params, losses


def main(argv=None):
    """Run one subcommand: `render` returns its image [H, W, 3], `optimize`
    its (params, losses)."""
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.cmd == "render":
        return cmd_render(args, parser)
    return cmd_optimize(args, parser)


def entry() -> int:
    """Console-script entry (`dpt-tpu-torch`): exit status 0 on success."""
    main()
    return 0


if __name__ == "__main__":
    main()
