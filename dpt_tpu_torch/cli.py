"""Command-line entry point: `render`, `optimize`, `interactive` and `info`.

Counterpart of those subcommands of `dpt_tpu/cli.py`:
    python -m dpt_tpu_torch.cli render --preset box512 --out out.png
    python -m dpt_tpu_torch.cli render --device cpu --width 16 --height 16
    python -m dpt_tpu_torch.cli render --scene path/to.obj --checkpoint c.npz
    python -m dpt_tpu_torch.cli render --width 64 --height 64 --out t.npy
    python -m dpt_tpu_torch.cli optimize --width 64 --height 64 \\
        --target t.npy --opt-params albedo --init-albedo 0.4 0.4 0.4
    python -m dpt_tpu_torch.cli interactive --out-dir shots < commands.txt
    python -m dpt_tpu_torch.cli info

Multi-process (`render` and `optimize`): start the same command once per
rank with `--num-processes N --process-id R --coordinator HOST:PORT`
(dist/sharding.py picks the backend: nccl with a card per rank, gloo on
the CPU or on shared cards).  `--sharded` splits the frame's rows over the
ranks; rank 0 alone writes files (image, checkpoint, recovered
parameters, the --metrics file; the other ranks log their metrics rows to
standard output), and a resume takes rank 0's checkpoint on every rank.

The default device is `cuda`, and a command fails when no card is present;
the CPU runs only when asked for with `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys

PRESET_NAMES = ["box256", "box512", "sylveon512", "sylveon1024",
                "sylveon2048"]
TRAVERSALS = ["brute", "quad", "pallas", "bvh", "packet", "threaded"]

# RenderConfig fields that change what is rendered.  A checkpoint's config
# key hashes only these and the scene choice: the others (traversal, BVH
# build, packet_tile, ray_sort, compact_frac, the remat flags, ...) change
# how fast the same estimate is computed, and toggling one must not discard
# a valid resume.
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


def _add_scene_args(r):
    """Scene and device arguments of every rendering command."""
    r.add_argument("--preset", choices=PRESET_NAMES)
    r.add_argument("--scene", help=".obj path (default: the box, or the "
                                   "procedural sphere for sylveon presets)")
    r.add_argument("--procedural-tris", type=_positive_int,
                   help="use the procedural Sylveon-class sphere with ~N "
                        "triangles instead of a preset's default scene")
    r.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")


def _add_cfg_args(r):
    """Config, scene, camera and device arguments of render and optimize."""
    _add_scene_args(r)
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--bounces", type=int)
    r.add_argument("--spp", type=int)
    r.add_argument("--traversal", choices=TRAVERSALS,
                   help="nearest/any-hit backend (quad = 4-wide BVH walk, "
                        "pallas = paired-children BVH walk, bvh / packet / "
                        "threaded = per-ray stack walk in torch ops)")
    r.add_argument("--bvh-builder", choices=["median", "sah", "lbvh"],
                   help="lbvh builds on the render device")
    r.add_argument("--leaf-size", type=_positive_int,
                   help="max triangles per BVH leaf")
    r.add_argument("--sort", action="store_true",
                   help="coherence-sort every query stream after the primary")
    r.add_argument("--wavefront-sort", action="store_true",
                   help="sort the whole carry once per bounce by hit "
                        "position (replaces --sort's per-query sort)")
    r.add_argument("--no-sss", action="store_true")
    r.add_argument("--rr", action="store_true", help="Russian roulette")
    r.add_argument("--compact-frac", type=_frac_or_auto, default=None,
                   help="carry compaction after the primary trace (> 0 on, "
                        "0 off; 'auto' derives it from a primary-hit probe)")
    r.add_argument("--metrics", help="JSONL metrics file (default stdout)")
    r.add_argument("--yaw", type=float, default=0.0)
    r.add_argument("--pitch", type=float, default=0.0)
    r.add_argument("--radius", type=float, default=5.0)
    r.add_argument("--sharded", action="store_true",
                   help="split the frame's rows over the ranks")
    r.add_argument("--coordinator", help="HOST:PORT of rank 0's rendezvous")
    r.add_argument("--num-processes", type=_positive_int,
                   help="ranks of the job (each runs this command)")
    r.add_argument("--process-id", type=int, help="this process's rank")


def _build_parser():
    p = argparse.ArgumentParser(prog="dpt_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene progressively")
    _add_cfg_args(r)
    r.add_argument("--batches", type=int, default=8)
    r.add_argument("--out", default="render.png",
                   help=".png (tonemapped) or .npy (raw radiance)")
    r.add_argument("--checkpoint",
                   help="npz accumulation checkpoint (resumed if it exists "
                        "and its framing matches)")
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--exposure", type=float, default=1.0)

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

    it = sub.add_parser(
        "interactive",
        help="headless interactive session: orbit / zoom / render commands "
             "on stdin (the mainLoop + input-event analog, "
             "VulkanRayTracer.cpp:717-860 + VulkanWindow.cpp:215-301)")
    _add_scene_args(it)
    it.add_argument("--width", type=int,
                    help="default: the preset's, else 256")
    it.add_argument("--height", type=int,
                    help="default: the preset's, else 256")
    it.add_argument("--bounces", type=int, default=2)
    it.add_argument("--traversal", choices=TRAVERSALS, default=None,
                    help="override the traversal (default: the preset's, "
                         "or brute without a preset)")
    it.add_argument("--no-sss", action="store_true")
    it.add_argument("--out-dir", default=".")
    it.add_argument("--exposure", type=float, default=1.0)

    sub.add_parser("info", help="print torch and device information")
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
    if args.wavefront_sort:
        over["wavefront_sort"] = True
    if args.no_sss:
        over["enable_sss"] = False
    if args.rr:
        over["russian_roulette"] = True
    if args.compact_frac is not None and args.compact_frac != "auto":
        over["compact_frac"] = args.compact_frac
    return cfg.replace(**over) if over else cfg


def _scene_choice(args):
    """The scene the arguments select: an .obj path > an explicit
    procedural triangle count > the preset's default (sylveon presets get
    the Sylveon-class procedural stand-in, everything else the box)."""
    if args.scene:
        return ("obj", args.scene)
    if args.procedural_tris:
        return ("procedural", args.procedural_tris)
    if args.preset and args.preset.startswith("sylveon"):
        return ("procedural", None)
    return ("box",)


def _pick_scene(args, device):
    from dpt_tpu_torch.scene.builder import (
        cornell_box_scene,
        load_scene,
        procedural_scene,
    )

    kind, *arg = _scene_choice(args)
    if kind == "obj":
        return load_scene(arg[0], device=device)
    if kind == "procedural":
        return (procedural_scene(n_tris_target=arg[0], device=device)
                if arg[0] else procedural_scene(device=device))
    return cornell_box_scene(device=device)


def _device(args, parser):
    import torch

    from dpt_tpu_torch.scene.scene import NO_CUDA

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(NO_CUDA)
    return device


def _join(args, parser, device):
    """Check the multi-process options and join the process group; returns
    the device this rank renders on."""
    from dpt_tpu_torch.dist.sharding import init_distributed, rank_device

    n = args.num_processes
    if n is None or n == 1:
        if args.coordinator is not None or args.process_id is not None:
            parser.error("--coordinator and --process-id need "
                         "--num-processes N > 1")
        return device
    if args.coordinator is None or args.process_id is None:
        parser.error(f"--num-processes {n} needs --coordinator HOST:PORT and "
                     "--process-id")
    if not 0 <= args.process_id < n:
        parser.error(f"--process-id {args.process_id} is not in [0, {n})")
    init_distributed(args.coordinator, n, args.process_id, device)
    return rank_device(device, args.process_id)


def _setup(args, parser):
    """Join the process group (multi-process runs), then (device, cfg,
    scene, orbit, camera, accel), with `--compact-frac auto` resolved by a
    probe render."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.render.renderer import auto_compact_frac
    from dpt_tpu_torch.scene.camera import OrbitCamera

    device = _join(args, parser, _device(args, parser))
    cfg = _make_cfg(args)
    scene = _pick_scene(args, device)
    orbit = OrbitCamera(yaw=args.yaw, pitch=args.pitch, radius=args.radius)
    camera = orbit.camera(device)
    accel = build_accel(scene, cfg)
    if args.compact_frac == "auto":
        frac = auto_compact_frac(scene, camera, cfg, accel)
        print(f"auto compact_frac = {frac:.4f}", file=sys.stderr)
        cfg = cfg.replace(compact_frac=frac)
    return device, cfg, scene, orbit, camera, accel


def _logger(args):
    """The metrics sink of this rank: --metrics on rank 0, standard output
    on the others; in a process group every row carries the rank, the
    world size and the backend."""
    import torch.distributed as dist

    from dpt_tpu_torch.dist.sharding import world
    from dpt_tpu_torch.utils.metrics import JsonlLogger

    rank, size = world()
    common = {}
    if size > 1:
        common = {"rank": rank, "world_size": size,
                  "backend": dist.get_backend()}
    return JsonlLogger(args.metrics if rank == 0 else None, **common)


class _Rank0Checkpointer:
    """The checkpointer render_progressive writes to in a process group:
    every rank calls save at the same batches (with --sharded each with its
    block of rows, assembled by gather_image); rank 0 alone writes."""

    def __init__(self, ckpt, sharded: bool, device):
        self.ckpt, self.sharded, self.device = ckpt, sharded, device

    def save(self, image, batch, extra=None, meta=None):
        import torch

        from dpt_tpu_torch.dist.sharding import gather_image, world

        if self.sharded:
            image = gather_image(torch.as_tensor(
                image, device=self.device)).cpu().numpy()
        if world()[0] == 0:
            self.ckpt.save(image, batch, extra=extra, meta=meta)


def _checkpoint_meta(args, orbit, cfg, setup=()):
    """Integrity meta of a checkpoint: the camera state plus a hash of the
    framing fields of cfg, the scene choice and `setup` (the optimisation
    setup of an optimize run)."""
    import numpy as np

    framing = {f: getattr(cfg, f) for f in _FRAMING_FIELDS}
    key = hashlib.sha1(repr((sorted(framing.items()), _scene_choice(args),
                             setup)).encode())
    return {"camera_state": np.asarray(orbit.state_tuple(), np.float64),
            "config_key": key.hexdigest()}


def cmd_render(args, parser):
    """Render, write the image and one metrics line per batch, resuming
    from and writing `--checkpoint`; returns the image [H, W, 3] on the
    render device (on every rank of a multi-process run)."""
    import torch

    from dpt_tpu_torch.dist.sharding import (
        broadcast,
        gather_image,
        rank_rows,
        render_sample_sharded,
        world,
    )
    from dpt_tpu_torch.render.renderer import render_progressive
    from dpt_tpu_torch.utils.checkpoint import Checkpointer, meta_matches
    from dpt_tpu_torch.utils.io import save_image

    device, cfg, scene, orbit, camera, accel = _setup(args, parser)
    rank, size = world()
    # Resuming under another framing would blend two accumulations; a
    # mismatch resets instead, as a camera change does
    # (VulkanRayTracer.cpp:739-754).
    meta = _checkpoint_meta(args, orbit, cfg)
    ckpt = Checkpointer(args.checkpoint) if args.checkpoint else None
    start_batch, start_image = 0, None
    loaded = ckpt.load() if ckpt is not None else None
    if loaded is not None:
        image_l, batch_l, aux = loaded
        if meta_matches(aux["meta"], meta["camera_state"],
                        meta["config_key"]):
            start_image, start_batch = image_l, batch_l
        else:
            print("checkpoint framing mismatch (camera/config changed): "
                  "resetting accumulation", file=sys.stderr)
    if size > 1:
        # Every rank resumes from rank 0's checkpoint: a rank without the
        # file would otherwise start at batch 0 and run another number of
        # batches than the others.
        image0 = torch.zeros((cfg.height, cfg.width, 3), device=device)
        if start_image is not None:
            image0 = torch.as_tensor(start_image, device=device)
        b, image0 = broadcast([torch.tensor([start_batch], device=device),
                               image0])
        start_batch = int(b)
        start_image = image0 if start_batch else None
    if start_batch:
        print(f"resuming from batch {start_batch}", file=sys.stderr)
    render_fn = None
    if args.sharded:
        render_fn = render_sample_sharded
        if start_image is not None:
            first, end = rank_rows(cfg, rank, size)
            start_image = torch.as_tensor(start_image, device=device)[
                first:end]
    each_ckpt = ckpt
    if ckpt is not None and size > 1:
        each_ckpt = _Rank0Checkpointer(ckpt, args.sharded, device)

    logger = _logger(args)
    try:
        def on_batch(b, img, metrics):
            logger.log(event="batch", batch=b, device=str(device), **metrics)

        img, n_done = render_progressive(
            scene, camera, cfg, accel=accel, n_batches=args.batches,
            on_batch=on_batch, checkpointer=each_ckpt,
            checkpoint_every=args.checkpoint_every, checkpoint_meta=meta,
            start_batch=start_batch, start_image=start_image,
            render_fn=render_fn)
    finally:
        logger.close()
    if args.sharded:
        img = gather_image(img)
    if rank == 0:
        full = img.cpu().numpy()
        if ckpt is not None:
            ckpt.save(full, n_done, meta=meta)
        save_image(args.out, full, exposure=args.exposure)
        print(f"wrote {args.out} ({n_done} batches)", file=sys.stderr)
    return img


def cmd_optimize(args, parser):
    """Inverse rendering: target image + starting scene -> optimisation
    steps with gradient accumulation, JSONL metrics and params + optimizer
    state checkpoint / resume.  Returns (params, losses)."""
    import numpy as np
    import torch

    from dpt_tpu_torch.diff.grads import split_params
    from dpt_tpu_torch.diff.optimize import (
        initial_opt_state,
        load_state,
        optimize,
        save_state,
    )
    from dpt_tpu_torch.dist.sharding import world
    from dpt_tpu_torch.utils.checkpoint import Checkpointer, meta_matches

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
    # The optimisation setup is part of the key: resuming another run
    # (other target, lr or parameters) must start fresh, not blend.
    meta = _checkpoint_meta(args, orbit, cfg, (
        args.init_albedo, args.target, args.lr, args.optimizer, opt_keys,
        args.micro_steps, args.backward, args.fixed_seeds))

    ckpt = Checkpointer(args.checkpoint) if args.checkpoint else None
    start_step, init_params, init_opt = 0, None, None
    loaded = ckpt.load() if ckpt is not None else None
    params_t = split_params(scene, camera)
    opt_t = initial_opt_state(args.optimizer, params_t, opt_keys)
    if loaded is not None and meta_matches(
            loaded[2]["meta"], meta["camera_state"], meta["config_key"]):
        restored = load_state(ckpt, params_t, opt_t)
        if restored is not None:
            start_step, init_params, init_opt = restored
    elif loaded is not None:
        print("checkpoint setup mismatch: starting fresh", file=sys.stderr)
    if world()[1] > 1:
        start_step, init_params, init_opt = _broadcast_opt_state(
            start_step, init_params or params_t, init_opt or opt_t, device)
    if start_step:
        print(f"resuming from step {start_step}", file=sys.stderr)

    logger = _logger(args)
    try:
        def on_step(step, loss, metrics):
            logger.log(event="opt_step", step=step, loss=loss,
                       device=str(device), **metrics)

        params, opt_state, losses = optimize(
            scene, camera, cfg, target,
            steps=max(args.steps, start_step), lr=args.lr,
            optimizer=args.optimizer, opt_params=opt_keys,
            micro_steps=args.micro_steps, accel=accel,
            backward=args.backward, sharded=args.sharded, checkpointer=ckpt,
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
    if world()[0] == 0:
        np.savez(args.out, **{k: v.detach().cpu().numpy()
                              for k, v in params.items()})
        print(f"wrote {args.out} (final loss "
              f"{losses[-1] if losses else float('nan'):.6g})",
              file=sys.stderr)
    return params, losses


def _broadcast_opt_state(start_step, params, opt_state, device):
    """Rank 0's (start_step, params, optimizer state) on every rank.  The
    JAX package reads the checkpoint on each process, so a process without
    the file starts at step 0 while the others resume, and the job hangs in
    mismatched collectives; here every rank takes rank 0's."""
    import torch

    from dpt_tpu_torch.dist.sharding import broadcast
    from dpt_tpu_torch.utils.checkpoint import flatten, unflatten

    tree = {"params": params, "opt_state": opt_state}
    leaves = broadcast([torch.tensor([start_step], device=device)]
                       + flatten(tree))
    out = unflatten(tree, leaves[1:], device)
    return int(leaves[0]), out["params"], out["opt_state"]


def _interactive_cfg(args):
    """A preset keeps its own resolution unless --width / --height are
    given; without a preset the frame is 256² by default.  Batches are
    1 spp, like the reference's dispatches (VulkanRayTracer.cpp:811)."""
    from dpt_tpu_torch.config import RenderConfig, preset

    size = {k: v for k, v in (("width", args.width),
                              ("height", args.height)) if v is not None}
    if args.preset:
        cfg = preset(args.preset).replace(
            max_depth=args.bounces, spp=1, enable_sss=not args.no_sss,
            **size)
        return cfg.replace(traversal=args.traversal) if args.traversal \
            else cfg
    trav = args.traversal or "brute"
    bvh = trav in ("pallas", "quad")
    return RenderConfig(
        **{"width": 256, "height": 256, **size}, max_depth=args.bounces,
        spp=1, traversal=trav, enable_sss=not args.no_sss,
        bvh_builder="sah" if bvh else "median",
        bvh_leaf_size=8 if bvh else 4, ray_sort=bvh,
    )


def cmd_interactive(args, parser, stdin=None, stdout=None):
    """Headless interactive loop: the reference's progressive mainLoop with
    camera-change reset (VulkanRayTracer.cpp:717-860), driven by text
    commands instead of Qt mouse events (VulkanWindow.cpp:215-301).

    Commands (one per line on stdin):
        orbit DX DY     mouse-drag orbit by pixel deltas (Camera.cpp:37-64)
        zoom FACTOR     wheel zoom (x0.9 / x1.1 in the reference)
        fov DEGREES     set the field of view
        render N        accumulate N more 1-spp batches
        save NAME       write the current accumulation to out-dir/NAME
        status          print the batches accumulated and the camera state
        quit            exit

    Every camera command resets the accumulation, like the reference's
    camera-change detection (VulkanRayTracer.cpp:739-754).  Returns the
    accumulated image [H, W, 3] on the render device."""
    import torch

    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.render.renderer import accumulate, render_sample
    from dpt_tpu_torch.scene.camera import OrbitCamera
    from dpt_tpu_torch.utils.io import save_image

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    device = _device(args, parser)
    cfg = _interactive_cfg(args)
    scene = _pick_scene(args, device)
    accel = build_accel(scene, cfg)
    orbit = OrbitCamera()
    img = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=device)
    batch = 0

    def reset():
        nonlocal img, batch
        img = torch.zeros_like(img)
        batch = 0

    for line in stdin:
        parts = line.split()
        if not parts:
            continue
        cmd, rest = parts[0], parts[1:]
        if cmd == "orbit" and len(rest) == 2:
            orbit = orbit.view_update(float(rest[0]), float(rest[1]))
            reset()
        elif cmd == "zoom" and len(rest) == 1:
            orbit = orbit.zoom_update(float(rest[0]))
            reset()
        elif cmd == "fov" and len(rest) == 1:
            orbit = dataclasses.replace(orbit, fov_deg=float(rest[0]))
            reset()
        elif cmd == "render" and len(rest) == 1:
            camera = orbit.camera(device)
            for _ in range(int(rest[0])):
                sample = render_sample(scene, camera, cfg, batch, accel)
                img = accumulate(img, sample, batch, cfg)
                batch += 1
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            print(f"rendered to batch {batch}", file=stdout, flush=True)
        elif cmd == "save" and len(rest) == 1:
            path = os.path.join(args.out_dir, rest[0])
            save_image(path, img.cpu().numpy(), exposure=args.exposure)
            print(f"saved {path} ({batch} batches)", file=stdout, flush=True)
        elif cmd == "status":
            print(f"batches={batch} yaw={orbit.yaw:.2f} "
                  f"pitch={orbit.pitch:.2f} radius={orbit.radius:.3f} "
                  f"fov={orbit.fov_deg:.1f}", file=stdout, flush=True)
        elif cmd == "quit":
            break
        else:
            print(f"unknown command: {line.strip()!r}", file=stdout,
                  flush=True)
    return img


def cmd_info():
    """Print (and return) the torch version, whether CUDA is available and
    the names of the CUDA devices, as JSON."""
    import torch

    info = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())],
    }
    print(json.dumps(info, indent=2))
    return info


def main(argv=None):
    """Run one subcommand: `render` returns its image [H, W, 3], `optimize`
    its (params, losses), `interactive` its last accumulation, `info` its
    dict."""
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.cmd == "render":
        return cmd_render(args, parser)
    if args.cmd == "optimize":
        return cmd_optimize(args, parser)
    if args.cmd == "interactive":
        return cmd_interactive(args, parser)
    return cmd_info()


def entry() -> int:
    """Console-script entry (`dpt-tpu-torch`): exit status 0 on success."""
    main()
    return 0


if __name__ == "__main__":
    main()
