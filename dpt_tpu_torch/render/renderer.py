"""Render drivers: one sample batch, accumulation, and the progressive loop.

Counterpart of `dpt_tpu/render/renderer.py` (`render_sample`, the tape's
`render_sample_taped` / `render_sample_playback`, `accumulate`, `render`,
and a serial `render_progressive`).  The reference dispatches one 1-spp
kernel per iteration and keeps a running average (VulkanRayTracer.cpp:
717-860, raytrace_comp.comp:467-469).  Everything runs on the device of the
scene; the accel must live there too.

Not ported yet: the live fraction diagnostics, checkpointing, pipelined
dispatch, `render_fn` and camera-source reset of the progressive loop
(ROADMAP Queue 1 item 3), and sharding (item 4).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from dpt_tpu_torch.config import RenderConfig
from dpt_tpu_torch.render.integrator import _checkpointed, trace_paths
from dpt_tpu_torch.render.raygen import generate_rays
from dpt_tpu_torch.render.rng import MASK32
from dpt_tpu_torch.render.trace import make_nearest, make_occluded
from dpt_tpu_torch.scene.scene import tensors


def _sub_batch(sample_batch, cfg: RenderConfig, s: int) -> int:
    return (int(sample_batch) * cfg.spp + s) & MASK32


def _image(acc, cfg: RenderConfig):
    return (acc / float(cfg.spp)).reshape(cfg.height, cfg.width, 3)


def _records_grad(scene, camera) -> bool:
    """Whether autograd would record this render: grad mode is on and some
    scene or camera tensor requires grad.  When not, the render runs under
    no_grad and never reaches torch.utils.checkpoint."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for obj in (scene, camera) for t in tensors(obj))


def _accumulate_spp(one_spp, cfg: RenderConfig, device, records: bool):
    """Sum of one_spp(s) over the sub-samples, each rematerialised in the
    backward under cfg.remat_bounces when autograd records."""
    acc = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=device)
    with torch.set_grad_enabled(records):
        for s in range(cfg.spp):
            acc = acc + (_checkpointed(one_spp, s) if cfg.remat_bounces
                         else one_spp(s))
    return acc


def render_sample(scene, camera, cfg: RenderConfig, sample_batch, accel=None):
    """One sample batch: cfg.spp sub-samples averaged → image [H, W, 3].

    Sub-sample s of batch b seeds pixels with batch index b*spp + s
    (uint32 wrap), mirroring the reference's per-dispatch seeding
    (raytrace_comp.comp:435).  Differentiable with respect to the scene and
    camera tensors; under autograd with cfg.remat_bounces each sub-sample
    (and each bounce in it) is rematerialised in the backward.
    """
    nearest = make_nearest(scene, cfg, accel)
    occluded = make_occluded(scene, cfg, accel)

    def one_spp(s):
        origin, direction, state = generate_rays(
            camera, cfg, _sub_batch(sample_batch, cfg, s))
        return trace_paths(origin, direction, state, scene, nearest, cfg,
                           occluded)

    return _image(_accumulate_spp(one_spp, cfg, scene.device,
                                  _records_grad(scene, camera)), cfg)


@torch.no_grad()
def render_sample_taped(scene, camera, cfg: RenderConfig, sample_batch,
                        accel=None):
    """`render_sample` that also returns the query tape: one recorded tape
    per sub-sample, in order.  Runs under no_grad: it is the forward of the
    tape backward and is never differentiated itself."""
    nearest = make_nearest(scene, cfg, accel)
    occluded = make_occluded(scene, cfg, accel)
    acc = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32,
                      device=scene.device)
    tapes = []
    for s in range(cfg.spp):
        origin, direction, state = generate_rays(
            camera, cfg, _sub_batch(sample_batch, cfg, s))
        radiance, tape = trace_paths(origin, direction, state, scene,
                                     nearest, cfg, occluded, tape="record")
        acc = acc + radiance
        tapes.append(tape)
    return _image(acc, cfg), tapes


def render_sample_playback(scene, camera, cfg: RenderConfig, sample_batch,
                           tapes):
    """Play a recorded render back: every traversal outcome comes from
    `tapes` (render_sample_taped), so no accel is needed and no traversal
    kernel or per-query sort runs.  The same image as `render_sample`, and
    differentiable; cfg.remat_bounces rematerialises each sub-sample, and
    with cfg.playback_remat_bounces each bounce as well."""
    if len(tapes) != cfg.spp:
        raise ValueError(f"{len(tapes)} tapes for spp={cfg.spp}")
    cfg_b = cfg.replace(
        remat_bounces=cfg.remat_bounces and cfg.playback_remat_bounces)

    def one_spp(s):
        origin, direction, state = generate_rays(
            camera, cfg, _sub_batch(sample_batch, cfg, s))
        return trace_paths(origin, direction, state, scene, None, cfg_b,
                           None, tape=tapes[s])

    return _image(_accumulate_spp(one_spp, cfg, scene.device,
                                  _records_grad(scene, camera)), cfg)


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
