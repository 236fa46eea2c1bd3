"""Driver entry points of the port: the flagship forward and a multi-rank
dry run of one training step.

Counterpart of `__graft_entry__.py`:

    python -m dpt_tpu_torch.entry [--device cpu] [--ranks N]

runs `entry()`'s forward once, then `dryrun_multichip(N)` (N: the number
of cards, at least 2).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from dpt_tpu_torch.config import RenderConfig


def entry(device="cuda"):
    """(fn, example_args): the forward render step of the flagship path at
    128², over a Sylveon-class procedural mesh of 8,000 triangles: the
    4-wide BVH walk (K1 on the card) with the per-query coherence sort and
    the full feature set (NEE, SSS, DoF, direct-view).
    fn(scene, camera, sample_batch, accel) -> image [128, 128, 3]."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.render.renderer import render_sample
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    cfg = RenderConfig(
        width=128, height=128, max_depth=4, spp=1,
        traversal="quad", bvh_builder="sah", bvh_leaf_size=8,
        packet_tile=1024, ray_sort=True,
    )
    scene = procedural_scene(n_tris_target=8000, device=device)
    camera = OrbitCamera().camera(device)
    accel = build_accel(scene, cfg)

    def fn(scene, camera, sample_batch, accel):
        return render_sample(scene, camera, cfg, sample_batch, accel)

    return fn, (scene, camera, 0, accel)


def dryrun_config(n_ranks: int) -> RenderConfig:
    """The dry run's config: the flagship program (K1, per-query sort,
    compaction, SSS with one step) at 8 rows x 32 pixels per rank, 2
    bounces."""
    return RenderConfig(
        width=32, height=8 * n_ranks, max_depth=2,
        spp=1, traversal="quad", bvh_builder="sah", bvh_leaf_size=8,
        packet_tile=256, ray_sort=True, enable_sss=True, sss_bounces=1,
        compact_frac=0.5,
    )


def dryrun_rank(device="cuda") -> dict:
    """One rank's part of the dry run, in a process group that is up (or
    alone): one tile-sharded tape step (forward recording the tape per
    rank, backward over the playback, loss and gradients all-reduced) with
    an SGD update at lr 1e-2, whose loss must be finite; then the sharded
    forward, gathered, must equal the single render of the whole frame
    (atol 1e-5).  Returns the loss and the largest image difference."""
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.diff.grads import split_params
    from dpt_tpu_torch.dist.sharding import (
        gather_image,
        render_sample_sharded,
        sharded_tape_loss_and_grads,
        world,
    )
    from dpt_tpu_torch.render.renderer import render_sample
    from dpt_tpu_torch.scene.builder import procedural_scene
    from dpt_tpu_torch.scene.camera import OrbitCamera

    _, size = world()
    cfg = dryrun_config(size)
    scene = procedural_scene(n_tris_target=300, device=device)
    camera = OrbitCamera().camera(device)
    accel = build_accel(scene, cfg)
    target = torch.zeros((cfg.height, cfg.width, 3), device=device)

    loss, grads = sharded_tape_loss_and_grads(scene, camera, cfg, target, 0,
                                              accel)
    params = {k: p - 1e-2 * grads[k]
              for k, p in split_params(scene, camera).items()}
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"dry-run loss {float(loss)} is not finite")
    if not all(bool(torch.isfinite(p).all()) for p in params.values()):
        raise AssertionError("dry-run SGD update is not finite")

    sharded = gather_image(render_sample_sharded(scene, camera, cfg, 0,
                                                 accel))
    single = render_sample(scene, camera, cfg, 0, accel)
    if not torch.allclose(sharded, single, atol=1e-5):
        raise AssertionError("sharded render != single render")
    return {"loss": float(loss),
            "max_abs_diff": float((sharded - single).abs().max())}


def dryrun_multichip(n_devices: int, device="cuda", timeout=600.0) -> list:
    """Start `n_devices` ranks of this module on this machine, each on its
    own card when there are enough, and run `dryrun_rank` on every rank
    (dist/sharding.py picks nccl or gloo).  Raises with the ranks' output
    if one fails or the run outlasts `timeout` seconds; returns each rank's
    result."""
    from dpt_tpu_torch.dist.launch import free_port, run_ranks

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    port = free_port()
    outs = run_ranks([[sys.executable, "-m", "dpt_tpu_torch.entry",
                       "--device", str(device), "--rank", str(r), "--ranks",
                       str(n_devices), "--port", str(port)]
                      for r in range(n_devices)], timeout, env=env)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dpt_tpu_torch.entry")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: the number of "
                         "cards, at least 2)")
    ap.add_argument("--rank", type=int, default=None,
                    help="run one rank of the dry run (internal)")
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        from dpt_tpu_torch.dist.sharding import init_distributed, rank_device

        init_distributed(f"localhost:{args.port}", args.ranks, args.rank,
                         args.device)
        out = dryrun_rank(rank_device(args.device, args.rank))
        print(json.dumps({"rank": args.rank, **out}), flush=True)
        return
    fn, example = entry(args.device)
    img = fn(*example)
    print(f"entry ok: {tuple(img.shape)} {float(img.mean())}", flush=True)
    n = args.ranks or max(torch.cuda.device_count(), 2)
    print(f"dryrun_multichip ok: {dryrun_multichip(n, args.device)}",
          flush=True)


if __name__ == "__main__":
    main()
