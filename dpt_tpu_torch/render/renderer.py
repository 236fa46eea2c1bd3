"""Render drivers: one sample batch, accumulation, and the progressive loop.

Counterpart of `dpt_tpu/render/renderer.py` (`render_sample`, the tape's
`render_sample_taped` / `render_sample_playback`, `accumulate`, `render`,
the pipelined `render_progressive` with camera-source reset and
checkpoints, and the `live_fraction_by_depth` / `auto_compact_frac`
diagnostics).  The reference dispatches one 1-spp kernel per iteration and
keeps a running average, resetting it when the camera moves
(VulkanRayTracer.cpp:717-860, raytrace_comp.comp:467-469).  Everything runs
on the device of the scene; the accel must live there too.  The one-batch
renders take `pixels=(px, py)` to render a block of whole rows only (the
rank's rows of dist/sharding.py).
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
    """[rows, W, 3]: the whole frame, or the block of rows rendered."""
    return (acc / float(cfg.spp)).reshape(-1, cfg.width, 3)


def _n_rays(cfg: RenderConfig, pixels) -> int:
    return cfg.n_pixels if pixels is None else pixels[0].numel()


def _rays(camera, cfg: RenderConfig, sample_batch, s: int, pixels):
    px, py = pixels if pixels is not None else (None, None)
    return generate_rays(camera, cfg, _sub_batch(sample_batch, cfg, s),
                         px, py)


def _records_grad(scene, camera) -> bool:
    """Whether autograd would record this render: grad mode is on and some
    scene or camera tensor requires grad.  When not, the render runs under
    no_grad and never reaches torch.utils.checkpoint."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for obj in (scene, camera) for t in tensors(obj))


def _accumulate_spp(one_spp, cfg: RenderConfig, n_rays: int, device,
                    records: bool):
    """Sum of one_spp(s) over the sub-samples, each rematerialised in the
    backward under cfg.remat_bounces when autograd records."""
    acc = torch.zeros((n_rays, 3), dtype=torch.float32, device=device)
    with torch.set_grad_enabled(records):
        for s in range(cfg.spp):
            acc = acc + (_checkpointed(one_spp, s) if cfg.remat_bounces
                         else one_spp(s))
    return acc


def render_sample(scene, camera, cfg: RenderConfig, sample_batch, accel=None,
                  pixels=None):
    """One sample batch: cfg.spp sub-samples averaged → image [H, W, 3]
    (with `pixels`, the [rows, W, 3] block of those pixels, which must be
    whole rows in raster order).

    Sub-sample s of batch b seeds pixels with batch index b*spp + s
    (uint32 wrap), mirroring the reference's per-dispatch seeding
    (raytrace_comp.comp:435).  Differentiable with respect to the scene and
    camera tensors; under autograd with cfg.remat_bounces each sub-sample
    (and each bounce in it) is rematerialised in the backward.
    """
    nearest = make_nearest(scene, cfg, accel)
    occluded = make_occluded(scene, cfg, accel)

    def one_spp(s):
        origin, direction, state = _rays(camera, cfg, sample_batch, s, pixels)
        return trace_paths(origin, direction, state, scene, nearest, cfg,
                           occluded)

    return _image(_accumulate_spp(one_spp, cfg, _n_rays(cfg, pixels),
                                  scene.device,
                                  _records_grad(scene, camera)), cfg)


@torch.no_grad()
def render_sample_taped(scene, camera, cfg: RenderConfig, sample_batch,
                        accel=None, pixels=None):
    """`render_sample` that also returns the query tape: one recorded tape
    per sub-sample, in order.  Runs under no_grad: it is the forward of the
    tape backward and is never differentiated itself."""
    nearest = make_nearest(scene, cfg, accel)
    occluded = make_occluded(scene, cfg, accel)
    acc = torch.zeros((_n_rays(cfg, pixels), 3), dtype=torch.float32,
                      device=scene.device)
    tapes = []
    for s in range(cfg.spp):
        origin, direction, state = _rays(camera, cfg, sample_batch, s, pixels)
        radiance, tape = trace_paths(origin, direction, state, scene,
                                     nearest, cfg, occluded, tape="record")
        acc = acc + radiance
        tapes.append(tape)
    return _image(acc, cfg), tapes


def render_sample_playback(scene, camera, cfg: RenderConfig, sample_batch,
                           tapes, pixels=None):
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
        origin, direction, state = _rays(camera, cfg, sample_batch, s, pixels)
        return trace_paths(origin, direction, state, scene, None, cfg_b,
                           None, tape=tapes[s])

    return _image(_accumulate_spp(one_spp, cfg, _n_rays(cfg, pixels),
                                  scene.device,
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


def _mark(device):
    """The point where the work queued so far completes: a timing CUDA
    event recorded on the current stream, or on the CPU (where that work is
    already done) the host clock."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _wait_ms(start, end) -> float:
    """Wait until `end` has completed; the ms from `start` to `end`."""
    if isinstance(end, float):
        return (end - start) * 1e3
    end.synchronize()
    return start.elapsed_time(end)


def render_progressive(
    scene,
    camera_source,
    cfg: RenderConfig,
    accel=None,
    n_batches: Optional[int] = None,
    on_batch: Optional[Callable] = None,
    checkpointer=None,
    checkpoint_every: int = 0,
    checkpoint_meta: Optional[dict] = None,
    start_batch: int = 0,
    start_image=None,
    render_fn: Optional[Callable] = None,
):
    """Progressive accumulation loop with camera-change reset.

    camera_source: a Camera, or a zero-argument callable returning the
    current (OrbitCamera state_tuple, Camera); when the state changes the
    accumulation restarts at batch 0 (VulkanRayTracer.cpp:739-754).

    on_batch(batch_idx, image, metrics) is called after each batch, with
    `batch_ms`, gross `rays_per_s` (every lane charged for every traversal,
    utils/metrics.traversals_per_sample) and `batches_done`; with a
    `checkpointer` and `checkpoint_every` > 0 the accumulation is saved
    after every checkpoint_every-th batch, with `checkpoint_meta`.
    render_fn(scene, camera, cfg, batch, accel) -> image replaces
    `render_sample`; the accumulation takes the shape of what it returns
    (a rank's block of rows under dist/sharding.py).  A resume passes
    `start_batch` and `start_image` (an array or tensor).  Returns (image,
    batches_accumulated).

    Dispatch is pipelined as in the JAX package: batch b+1 is queued
    before the host waits on batch b's CUDA event and publishes b
    (on_batch, then the checkpoint), so that host work overlaps device
    work.  The image is the serial loop's bit for bit (the accumulation is
    ordered on the stream).  batch_ms is completion to completion on the
    device clock: from the event after the previous batch (the first
    batch: an event recorded before its dispatch) to the event after this
    one, so a run's batch_ms sum to its span on the card.  (The JAX loop
    times a batch from its own dispatch, which with one batch in flight
    spans two batches.)
    """
    from dpt_tpu_torch.utils.metrics import traversals_per_sample

    if render_fn is None:
        render_fn = render_sample
    n = cfg.sample_batches if n_batches is None else n_batches
    dev = scene.device
    img = (torch.as_tensor(start_image, dtype=torch.float32, device=dev)
           if start_image is not None else None)  # zeros of the first batch
    rays_per_px = cfg.spp * traversals_per_sample(cfg, scene.lights.count)
    batch = start_batch
    prev_cam_state = None
    pending = None  # (batch index, image after it, start mark, end mark)
    last_mark = None  # the end mark of the batch dispatched last

    def publish(entry):
        """Wait for a finished batch and run its host-side effects."""
        b, pimg, start, end = entry
        dt = _wait_ms(start, end) / 1e3
        if on_batch is not None:
            on_batch(b, pimg, {
                "batch_ms": dt * 1e3,
                "rays_per_s": rays_per_px * pimg[..., 0].numel() / dt,
                "batches_done": b + 1,
            })
        if checkpointer is not None and checkpoint_every and (
                (b + 1) % checkpoint_every == 0):
            checkpointer.save(pimg.cpu().numpy(), b + 1,
                              meta=checkpoint_meta)

    while batch < n:
        if callable(camera_source):
            cam_state, camera = camera_source()
            if prev_cam_state is not None and cam_state != prev_cam_state:
                # Camera moved: reset the accumulation.  The batch in
                # flight finished under the old framing; publish it first.
                if pending is not None:
                    publish(pending)
                    pending = None
                img = None
                batch = 0
            prev_cam_state = cam_state
        else:
            camera = camera_source

        start = _mark(dev) if last_mark is None else last_mark
        with torch.profiler.record_function("render_batch"):
            sample = render_fn(scene, camera, cfg, batch, accel)
            if img is None:
                img = torch.zeros_like(sample)
            img = accumulate(img, sample, batch, cfg)
        last_mark = _mark(dev)
        if pending is not None:
            publish(pending)
        pending = (batch, img, start, last_mark)
        batch += 1
    if pending is not None:
        publish(pending)
    if img is None:
        img = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                          device=dev)
    return img, batch


@torch.no_grad()
def live_fraction_by_depth(scene, camera, cfg: RenderConfig, accel=None,
                           sample_batch=0):
    """Fraction of lanes alive entering each bounce (live_in[0] == 1.0):
    the bounce chain on every lane of one sub-sample, without compaction,
    for utils/metrics.effective_traversals_per_sample."""
    from dpt_tpu_torch.render.integrator import make_bounce_body

    if cfg.max_depth <= 1:
        return [1.0]
    nearest = make_nearest(scene, cfg, accel)
    occluded = make_occluded(scene, cfg, accel)
    o, d, st = generate_rays(camera, cfg, sample_batch)
    R = o.shape[0]
    body = make_bounce_body(scene, nearest, occluded, cfg)
    carry = (o, d, torch.ones((R, 3), dtype=torch.float32, device=o.device),
             torch.zeros((R, 3), dtype=torch.float32, device=o.device),
             torch.ones((R,), dtype=torch.bool, device=o.device), st)
    fractions = [1.0]
    for depth in range(cfg.max_depth - 1):
        carry = body(carry, depth)
        fractions.append(float(carry[4].float().mean()))
    return fractions


@torch.no_grad()
def auto_compact_frac(scene, camera, cfg: RenderConfig, accel=None,
                      margin: float = 1.05, probe_side: int = 256) -> float:
    """The carry-compaction fraction the JAX package derives from the
    primary-hit fraction of a probe render (`--compact-frac auto`).

    The probe keeps cfg's aspect ratio at most `probe_side` pixels on its
    long side (a square probe of a non-square frame would see another field
    of view); the capacity covers the hit lanes with `margin` headroom,
    rounded up to 128 lanes at the real size.  Returns 0.0 (compaction
    off) when that capacity is not smaller than the frame."""
    f = min(probe_side / max(cfg.width, cfg.height), 1.0)
    probe = cfg.replace(width=max(1, round(cfg.width * f)),
                        height=max(1, round(cfg.height * f)))
    nearest = make_nearest(scene, probe, accel)
    o, d, _ = generate_rays(camera, probe, 0)
    h = float(getattr(nearest, "unsorted", nearest)(o, d)["hit"].float()
              .mean())
    R = cfg.n_pixels
    C = max(128, int(-(-(h * margin * R) // 128) * 128))
    if C >= R:
        return 0.0
    return C / R
