"""Multi-process rendering and gradients: pixel rows split over ranks.

Counterpart of `dpt_tpu/dist/sharding.py`.  The JAX package shards pixel
rows over the 'tiles' axis of a device mesh and lets shard_map place the
gradient all-reduce; here every rank is a process of a torch.distributed
group, and the split and the collectives are spelled out:

  - rank r of W renders rows [r*H/W, (r+1)*H/W) (H % W == 0) through the
    port's own render (`render_sample(..., pixels=...)`: generate_rays and
    trace_paths on those pixels), the counterpart of `_tile_render`;
  - scene, camera and accel are replicated: every rank builds them itself,
    as every JAX process does;
  - a loss is the sum over ranks of each rank's rows' squared error
    divided by the frame's H*W*3; each rank runs the port's backward on its
    rows alone (plain, replay or tape, with its own tape), then one
    all_reduce(SUM) of one flat buffer holding the loss and every gradient
    makes every rank hold the frame's loss and gradients;
  - `gather_image` assembles the frame on every rank by all_gather of the
    row blocks.

Every collective here is issued by every rank the same number of times in
the same order, outside any branch that depends on a rank's data.  The
integrator compacts each rank's lanes into its own static capacity and
skips the chunks that hold none of its live lanes, so ranks differ in the
work they dispatch; no collective sits inside that code (the torch form
of the divergent-branch deadlock the JAX package's tests/test_sharding.py
guards against).

Backend rule (`backend_for`): `nccl` when every rank has a card of its own,
`gloo` when the ranks run on the CPU or share cards (NCCL refuses two ranks
on one device).  The rule is decided before the group starts, from the
device, the number of cards on this machine and the ranks on this machine
(LOCAL_WORLD_SIZE / LOCAL_RANK when a launcher sets them, so a job of
several machines with a card per rank gets nccl; else the world size); a
failed init is never retried with another backend.  `gloo` takes CUDA
tensors for all_reduce, broadcast and all_gather
(scripts/torch_gloo_cuda_probe.py on the H100).

Without a process group (or with one rank) every function here works on
the whole frame and no collective runs.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

from dpt_tpu_torch.config import RenderConfig
from dpt_tpu_torch.diff.grads import (
    PARAM_KEYS,
    render_loss_and_grads,
    replay_loss_and_grads,
    tape_loss_and_grads,
)
from dpt_tpu_torch.render.renderer import render_sample


def world() -> tuple:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local(name: str, default: int) -> int:
    """The launcher's `name` (LOCAL_WORLD_SIZE, LOCAL_RANK: torchrun sets
    them on every rank), else `default`."""
    value = os.environ.get(name)
    return int(value) if value else default


def backend_for(device, world_size: int) -> str:
    """'nccl' when the ranks render on CUDA and each rank of this machine
    has a card of its own, else 'gloo'.  The ranks on this machine are
    $LOCAL_WORLD_SIZE, else the world size (one machine)."""
    device = torch.device(device)
    if device.type == "cuda" and (_local("LOCAL_WORLD_SIZE", world_size)
                                  <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device rank `rank` renders on: `device` itself when it names an
    index or is not CUDA, else card ($LOCAL_RANK, else `rank`) % (cards on
    this machine)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", _local("LOCAL_RANK", rank)
                        % max(torch.cuda.device_count(), 1))


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device="cuda"):
    """Join the process group of `num_processes` ranks at `coordinator`
    ("host:port", or an init URL) as rank `process_id`; returns the backend,
    or None for a single process (nothing to join).  Idempotent: with a
    group already up it returns that group's backend.  Logs the backend on
    standard error."""
    if not num_processes or num_processes <= 1:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    dev = rank_device(device, process_id)
    backend = backend_for(dev, num_processes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    print(f"torch.distributed: rank {process_id} of {num_processes}, backend "
          f"{backend}, device {dev}", file=sys.stderr, flush=True)
    return backend


def rank_rows(cfg: RenderConfig, rank: int, size: int) -> tuple:
    """[first, end) of the rows rank `rank` of `size` renders."""
    if cfg.height % size:
        raise ValueError(f"height {cfg.height} must divide over {size} ranks")
    n = cfg.height // size
    return rank * n, (rank + 1) * n


def rank_pixels(cfg: RenderConfig, rank: int, size: int, device) -> tuple:
    """(px, py) [rows * W] int64 of the rank's rows, in raster order (the
    same order pixel_grid gives the whole frame)."""
    first, end = rank_rows(cfg, rank, size)
    py, px = torch.meshgrid(
        torch.arange(first, end, dtype=torch.int64, device=device),
        torch.arange(cfg.width, dtype=torch.int64, device=device),
        indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def render_sample_sharded(scene, camera, cfg: RenderConfig, sample_batch,
                          accel=None):
    """This rank's rows of one sample batch → [H / W, W, 3] (the whole
    frame for one rank).  Runs no collective: `gather_image` assembles the
    frame."""
    rank, size = world()
    return render_sample(scene, camera, cfg, sample_batch, accel,
                         pixels=rank_pixels(cfg, rank, size, scene.device))


def gather_image(block):
    """The whole frame [H, W, 3] on every rank, from each rank's block of
    rows (all_gather, in rank order)."""
    rank, size = world()
    if size == 1:
        return block
    blocks = [torch.empty_like(block) for _ in range(size)]
    dist.all_gather(blocks, block.contiguous())
    return torch.cat(blocks, dim=0)


def broadcast(tensors, src: int = 0) -> list:
    """Rank `src`'s values of `tensors` (same shapes and dtypes on every
    rank) on every rank: one broadcast per dtype, of the tensors flattened
    into one buffer on the first tensor's device.  Each result keeps its
    input's device."""
    if world()[1] == 1:
        return list(tensors)
    out = list(tensors)
    dev = tensors[0].device
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        ids = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].detach().reshape(-1).to(dev)
                          for i in ids])
        dist.broadcast(flat, src)
        for i, part in zip(ids, flat.split([tensors[i].numel()
                                            for i in ids])):
            out[i] = part.reshape(tensors[i].shape).to(tensors[i].device)
    return out


def all_reduce_loss_and_grads(value, grads: dict):
    """(loss, grads) summed over the ranks: one all_reduce of one flat
    buffer."""
    if world()[1] == 1:
        return value, grads
    parts = [value.reshape(1)] + [grads[k].reshape(-1) for k in PARAM_KEYS]
    flat = torch.cat(parts)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    out = flat.split([p.numel() for p in parts])
    return out[0].reshape(()), {k: o.reshape(grads[k].shape)
                                for k, o in zip(PARAM_KEYS, out[1:])}


def _sharded(local):
    """The sharded form of one of diff/grads.py's loss-and-grads
    functions: this rank's rows through `local`, then the all-reduce."""

    def run(scene, camera, cfg: RenderConfig, target, sample_batch=0,
            accel=None, loss="l2"):
        rank, size = world()
        first, end = rank_rows(cfg, rank, size)
        rows = target.reshape(cfg.height, cfg.width, 3)[first:end]
        value, grads = local(scene, camera, cfg, rows, sample_batch, accel,
                             loss, pixels=rank_pixels(cfg, rank, size,
                                                      scene.device))
        return all_reduce_loss_and_grads(value, grads)

    run.__doc__ = (f"`{local.__name__}` with the frame's rows split over the "
                   "ranks: (loss, {key: grad}) of the whole frame on every "
                   "rank.  target: the whole frame [H, W, 3].")
    return run


sharded_loss_and_grads = _sharded(render_loss_and_grads)
sharded_replay_loss_and_grads = _sharded(replay_loss_and_grads)
sharded_tape_loss_and_grads = _sharded(tape_loss_and_grads)
