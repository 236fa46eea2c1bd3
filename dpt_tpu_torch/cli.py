"""Command-line entry point: the `render` subcommand.

Counterpart of the `render` subcommand of `dpt_tpu/cli.py`:
    python -m dpt_tpu_torch.cli render --preset sylveon512 --out out.png
    python -m dpt_tpu_torch.cli render --device cpu --width 16 --height 16

The default device is `cuda`, and the command fails when no card is
present; the CPU runs only when asked for with `--device cpu`.  Options of
the JAX CLI that are not ported yet are accepted and exit with a
"not yet ported" error.
"""

from __future__ import annotations

import argparse
import sys

PRESET_NAMES = ["box256", "box512", "sylveon512", "sylveon1024",
                "sylveon2048"]

# option dest -> the ROADMAP item that ports it.
_NOT_PORTED = {
    "checkpoint": "--checkpoint (ROADMAP Queue 1 item 10)",
    "sharded": "--sharded (ROADMAP Queue 1 item 12)",
    "coordinator": "--coordinator (ROADMAP Queue 1 item 12)",
    "wavefront_sort": "--wavefront-sort (ROADMAP Queue 1 item 7)",
    "scene": "--scene (ROADMAP Queue 1 item 2, the OBJ loader)",
}


def _positive_int(s):
    v = int(s)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer: {s!r}")
    return v


def _build_parser():
    p = argparse.ArgumentParser(prog="dpt_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene progressively")
    r.add_argument("--preset", choices=PRESET_NAMES)
    r.add_argument("--procedural-tris", type=_positive_int,
                   help="use the procedural Sylveon-class sphere with ~N "
                        "triangles instead of a preset's default scene")
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--bounces", type=int)
    r.add_argument("--spp", type=int)
    r.add_argument("--traversal", choices=["brute", "quad"],
                   help="nearest/any-hit backend (quad = 4-wide BVH walk)")
    r.add_argument("--bvh-builder", choices=["median", "sah"])
    r.add_argument("--leaf-size", type=_positive_int,
                   help="max triangles per BVH leaf")
    r.add_argument("--sort", action="store_true",
                   help="coherence-sort every query stream after the primary")
    r.add_argument("--no-sss", action="store_true")
    r.add_argument("--rr", action="store_true", help="Russian roulette")
    r.add_argument("--compact-frac", type=float, default=None,
                   help="carry compaction after the primary trace "
                        "(> 0 on, 0 off)")
    r.add_argument("--batches", type=int, default=8)
    r.add_argument("--out", default="render.png")
    r.add_argument("--metrics", help="JSONL metrics file (default stdout)")
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--yaw", type=float, default=0.0)
    r.add_argument("--pitch", type=float, default=0.0)
    r.add_argument("--radius", type=float, default=5.0)
    r.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch walk)")
    # Accepted for command-line parity; not ported yet.
    r.add_argument("--checkpoint")
    r.add_argument("--sharded", action="store_true")
    r.add_argument("--coordinator")
    r.add_argument("--wavefront-sort", action="store_true")
    r.add_argument("--scene")
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


def cmd_render(args, parser):
    """Render, write the image and one metrics line per batch; returns the
    image [H, W, 3] on the render device."""
    import torch

    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.render.renderer import render_progressive
    from dpt_tpu_torch.scene.camera import OrbitCamera
    from dpt_tpu_torch.utils.io import save_image
    from dpt_tpu_torch.utils.metrics import JsonlLogger

    for dest, what in _NOT_PORTED.items():
        if getattr(args, dest):
            parser.error(f"{what} is not yet ported to dpt_tpu_torch")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available; pass --device cpu to "
                     "render on the CPU")

    cfg = _make_cfg(args)
    scene = _pick_scene(args, device)
    camera = OrbitCamera(yaw=args.yaw, pitch=args.pitch,
                         radius=args.radius).camera(device)
    accel = build_accel(scene, cfg)
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


def main(argv=None):
    """Run one subcommand; `render` returns its image [H, W, 3]."""
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.cmd == "render":
        return cmd_render(args, parser)
    return None


def entry() -> int:
    """Console-script entry (`dpt-tpu-torch`): exit status 0 on success."""
    main()
    return 0


if __name__ == "__main__":
    main()
