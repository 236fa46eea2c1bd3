"""Differentiable rendering: gradients of an image loss w.r.t. scene params.

Counterpart of `dpt_tpu/diff/grads.py`.  Three backward paths, all with the
fixed-hit detach convention (render/integrator.py) and all returning
`(loss, grads)` with the keys of `split_params`:

  - `render_loss_and_grads`: plain autograd through `render_sample`
    (each sub-sample and bounce rematerialised under cfg.remat_bounces).
  - `replay_loss_and_grads`: a `torch.autograd.Function` whose forward is
    an inference render that keeps only its inputs, and whose backward
    renders again under autograd.
  - `tape_loss_and_grads`: a `torch.autograd.Function` whose forward
    records every traversal outcome (the query tape) and whose backward
    differentiates the playback render, which runs no traversal at all.

The RNG is a counter in the ray state, so every re-render sees the same
samples: the three give the same loss and the same gradients up to
rounding.  With `pixels=(px, py)` each renders only those rows and takes
their squared error summed over the whole frame's H*W*3 elements: one
rank's share of the frame's loss (dist/sharding.py sums the shares).
"""

from __future__ import annotations

import dataclasses

import torch

from dpt_tpu_torch.config import RenderConfig
from dpt_tpu_torch.render.renderer import (
    render_sample,
    render_sample_playback,
    render_sample_taped,
)

#: The differentiable parameters, in a fixed order.
PARAM_KEYS = (
    "vertices", "albedo", "roughness", "emission",
    "light_intensity", "light_position",
    "camera_position", "camera_direction", "camera_up", "camera_fov",
)


def split_params(scene, camera) -> dict:
    """The differentiable parameters of (scene, camera): vertices, material
    fields, light intensity / position and the camera pose.  Topology and
    everything else stay in the structure."""
    return {
        "vertices": scene.vertices,
        "albedo": scene.materials.albedo,
        "roughness": scene.materials.roughness,
        "emission": scene.materials.emission,
        "light_intensity": scene.lights.intensity,
        "light_position": scene.lights.position,
        "camera_position": camera.position,
        "camera_direction": camera.direction,
        "camera_up": camera.up,
        "camera_fov": camera.fov_deg,
    }


def merge_params(params, scene, camera):
    """(scene, camera) with the tensors of `params` in place."""
    materials = dataclasses.replace(
        scene.materials,
        albedo=params["albedo"],
        roughness=params["roughness"],
        emission=params["emission"],
    )
    lights = dataclasses.replace(
        scene.lights,
        intensity=params["light_intensity"],
        position=params["light_position"],
    )
    scene = dataclasses.replace(scene, vertices=params["vertices"],
                                materials=materials, lights=lights)
    camera = dataclasses.replace(
        camera,
        position=params["camera_position"],
        direction=params["camera_direction"],
        up=params["camera_up"],
        fov_deg=params["camera_fov"],
    )
    return scene, camera


def differentiable_render(scene, camera, cfg: RenderConfig, sample_batch=0,
                          accel=None):
    """(f, params): f(params) -> image [H, W, 3], differentiable w.r.t. the
    tensors of params."""
    params = split_params(scene, camera)

    def f(p):
        s, c = merge_params(p, scene, camera)
        return render_sample(s, c, cfg, sample_batch, accel)

    return f, params


def _loss_of_img(loss: str, img, target, cfg=None, pixels=None):
    """The loss of a whole frame; of a block of rows (`pixels`), its share:
    the squared error summed and divided by the frame's H*W*3."""
    if loss != "l2":
        raise ValueError(f"unknown loss: {loss!r}")
    if pixels is None:
        return torch.mean((img - target) ** 2)
    return ((img - target) ** 2).sum() / (cfg.n_pixels * 3)


def _leaves(scene, camera):
    """Fresh leaf tensors that require grad, one per PARAM_KEYS entry."""
    p = split_params(scene, camera)
    return [p[k].detach().requires_grad_(True) for k in PARAM_KEYS]


def _grads_dict(params, grads):
    return {k: (torch.zeros_like(p) if g is None else g)
            for k, p, g in zip(PARAM_KEYS, params, grads)}


def _grad_of(loss_fn, g, target, params, needs_target):
    """Backward shared by the replay and tape Functions: re-evaluate
    loss_fn(params, target) under autograd and pull `g` back."""
    with torch.enable_grad():
        p = [x.detach().requires_grad_(True) for x in params]
        t = target.detach().requires_grad_(needs_target)
        loss = loss_fn(p, t)
        inputs = p + ([t] if needs_target else [])
        grads = torch.autograd.grad(loss, inputs, g, allow_unused=True)
    dt = grads[-1] if needs_target else None
    return dt, grads[:len(p)]


def render_loss_and_grads(scene, camera, cfg: RenderConfig, target,
                          sample_batch=0, accel=None, loss="l2",
                          pixels=None):
    """Loss against `target` and its gradients by plain autograd through
    `render_sample`.  Returns (loss 0-d tensor, {key: grad})."""
    params = _leaves(scene, camera)
    s, c = merge_params(dict(zip(PARAM_KEYS, params)), scene, camera)
    value = _loss_of_img(loss, render_sample(s, c, cfg, sample_batch, accel,
                                             pixels), target, cfg, pixels)
    grads = torch.autograd.grad(value, params, allow_unused=True)
    return value.detach(), _grads_dict(params, grads)


class _Replay(torch.autograd.Function):
    """Forward: an inference render that saves only its inputs.  Backward:
    the same render again, under autograd."""

    @staticmethod
    def forward(ctx, loss_fn, target, *params):
        ctx.loss_fn = loss_fn
        ctx.save_for_backward(target, *params)
        return loss_fn(params, target)

    @staticmethod
    def backward(ctx, g):
        target, *params = ctx.saved_tensors
        dt, dp = _grad_of(ctx.loss_fn, g, target, params,
                          ctx.needs_input_grad[1])
        return (None, dt, *dp)


class _Tape(torch.autograd.Function):
    """Forward: the taped render, keeping the tape.  Backward: the playback
    render under autograd, which calls no traversal."""

    @staticmethod
    def forward(ctx, record_fn, play_fn, target, *params):
        loss, tapes = record_fn(params, target)
        ctx.play_fn = play_fn
        ctx.tapes = tapes
        ctx.save_for_backward(target, *params)
        return loss

    @staticmethod
    def backward(ctx, g):
        target, *params = ctx.saved_tensors
        tapes = ctx.tapes
        dt, dp = _grad_of(lambda p, t: ctx.play_fn(p, t, tapes), g, target,
                          params, ctx.needs_input_grad[2])
        return (None, None, dt, *dp)


def _merged(scene, camera, params):
    return merge_params(dict(zip(PARAM_KEYS, params)), scene, camera)


def replay_loss_and_grads(scene, camera, cfg: RenderConfig, target,
                          sample_batch=0, accel=None, loss="l2",
                          pixels=None):
    """Replay backward: the forward keeps no activations at all, the
    backward re-renders under autograd.  Returns (loss, {key: grad})."""

    def loss_fn(params, t):
        s, c = _merged(scene, camera, params)
        return _loss_of_img(loss, render_sample(s, c, cfg, sample_batch,
                                                accel, pixels), t, cfg,
                            pixels)

    params = _leaves(scene, camera)
    value = _Replay.apply(loss_fn, target, *params)
    grads = torch.autograd.grad(value, params, allow_unused=True)
    return value.detach(), _grads_dict(params, grads)


def tape_loss_and_grads(scene, camera, cfg: RenderConfig, target,
                        sample_batch=0, accel=None, loss="l2", pixels=None):
    """Tape backward: the forward records every traversal outcome
    (integrator.QueryTape) and the backward differentiates the playback
    render, so no traversal kernel and no per-query sort runs in the
    backward.  The loss is the plain forward's; the gradients are the
    replay's up to rounding.  Returns (loss, {key: grad})."""

    def record_fn(params, t):
        s, c = _merged(scene, camera, params)
        img, tapes = render_sample_taped(s, c, cfg, sample_batch, accel,
                                         pixels)
        return _loss_of_img(loss, img, t, cfg, pixels), tapes

    def play_fn(params, t, tapes):
        s, c = _merged(scene, camera, params)
        return _loss_of_img(loss, render_sample_playback(
            s, c, cfg, sample_batch, tapes, pixels), t, cfg, pixels)

    params = _leaves(scene, camera)
    value = _Tape.apply(record_fn, play_fn, target, *params)
    grads = torch.autograd.grad(value, params, allow_unused=True)
    return value.detach(), _grads_dict(params, grads)
