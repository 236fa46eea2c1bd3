"""Render drivers: one sample batch, accumulation, and the progressive loop.

Counterpart of `dpt_tpu/render/renderer.py` (`render_sample`, `accumulate`,
`render`, and a serial `render_progressive`).  The reference dispatches one
1-spp kernel per iteration and keeps a running average
(VulkanRayTracer.cpp:717-860, raytrace_comp.comp:467-469).  Everything runs
on the device of the scene; the accel must live there too.

Not ported yet (ROADMAP Queue 1 items 9-12): the tape renders, the live
fraction diagnostics, checkpointing, pipelined dispatch, `render_fn`
sharding and camera-source reset.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from dpt_tpu_torch.config import RenderConfig
from dpt_tpu_torch.render.integrator import trace_paths
from dpt_tpu_torch.render.raygen import generate_rays
from dpt_tpu_torch.render.rng import MASK32
from dpt_tpu_torch.render.trace import make_nearest, make_occluded


def render_sample(scene, camera, cfg: RenderConfig, sample_batch, accel=None):
    """One sample batch: cfg.spp sub-samples averaged → image [H, W, 3].

    Sub-sample s of batch b seeds pixels with batch index b*spp + s
    (uint32 wrap), mirroring the reference's per-dispatch seeding
    (raytrace_comp.comp:435).
    """
    nearest = make_nearest(scene, cfg, accel)
    occluded = make_occluded(scene, cfg, accel)
    acc = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32,
                      device=scene.device)
    for s in range(cfg.spp):
        sb = (int(sample_batch) * cfg.spp + s) & MASK32
        origin, direction, state = generate_rays(camera, cfg, sb)
        acc = acc + trace_paths(origin, direction, state, scene, nearest, cfg,
                                occluded)
    img = acc / float(cfg.spp)
    return img.reshape(cfg.height, cfg.width, 3)


def accumulate(prev_img, new_img, batch, cfg: RenderConfig):
    """Progressive running average (raytrace_comp.comp:467-469):
    new = (prev * batch + sample) / (batch + 1)."""
    b = float(batch)
    return (prev_img * b + new_img) / (b + 1.0)


def render(scene, camera, cfg: RenderConfig, n_batches: Optional[int] = None,
           accel=None):
    """Blocking render of `n_batches` progressive batches → image [H, W, 3]."""
    n = cfg.sample_batches if n_batches is None else n_batches
    img = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=scene.device)
    for b in range(n):
        sample = render_sample(scene, camera, cfg, b, accel)
        img = accumulate(img, sample, b, cfg)
    return img


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_progressive(scene, camera, cfg: RenderConfig, accel=None,
                       n_batches: Optional[int] = None,
                       on_batch: Optional[Callable] = None):
    """Serial progressive accumulation of `n_batches` batches.

    on_batch(batch_idx, image, metrics) is called after each batch, with
    metrics `batch_ms` (host clock around the batch, ending in a device
    synchronise), gross `rays_per_s` (every lane charged for every
    traversal, utils/metrics.traversals_per_sample) and `batches_done`.
    Returns (image, batches_accumulated).
    """
    from dpt_tpu_torch.utils.metrics import traversals_per_sample

    n = cfg.sample_batches if n_batches is None else n_batches
    dev = scene.device
    img = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=dev)
    rays = cfg.n_pixels * cfg.spp * traversals_per_sample(
        cfg, scene.lights.count)
    for b in range(n):
        _sync(dev)
        t0 = time.perf_counter()
        sample = render_sample(scene, camera, cfg, b, accel)
        img = accumulate(img, sample, b, cfg)
        _sync(dev)
        dt = time.perf_counter() - t0
        if on_batch is not None:
            on_batch(b, img, {
                "batch_ms": dt * 1e3,
                "rays_per_s": rays / dt,
                "batches_done": b + 1,
            })
    return img, n
