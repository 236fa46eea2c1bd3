"""Inverse rendering: recover scene / camera parameters from a target image.

Counterpart of `dpt_tpu/diff/optimize.py`.  Per optimisation step:

  1. with "vertices" among the optimised parameters, refit the quad accel
     to the current vertices (kernels/quad.refit_quad), so hit selection
     never runs against stale baked geometry;
  2. `micro_steps` gradient-accumulation renders, each with its own
     counter-based seed (step * micro_steps + m, or m with fixed seeds), so
     a resumed run continues the exact sample stream;
  3. one `torch.optim` Adam / SGD update of the selected parameters; the
     others are never handed to the optimizer and stay bit-identical;
  4. metrics through `on_step`, and parameters + optimizer state through
     utils/checkpoint.Checkpointer.

The backward is the tape (`diff/grads.tape_loss_and_grads`) by default, or
the replay.  With `sharded=True` the frame's rows are split over the ranks
of the process group (dist/sharding.py): each rank renders and
differentiates its rows, the loss and gradients are all-reduced before the
update, so every rank takes the same step, and rank 0 alone writes the
checkpoint.  torch's Adam places eps as optax's does in exact arithmetic
(m_hat / (sqrt(v_hat) + eps)) but rounds in another order, so a run agrees
with the JAX package's `optimize` to allclose, not bit for bit.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from dpt_tpu_torch.config import RenderConfig
from dpt_tpu_torch.diff.grads import (
    PARAM_KEYS,
    merge_params,
    replay_loss_and_grads,
    split_params,
    tape_loss_and_grads,
)
from dpt_tpu_torch.utils.checkpoint import flatten, unflatten

#: parameter keys accepted by --opt-params (diff/grads.split_params)
OPTIMIZABLE = PARAM_KEYS

def make_optimizer(name: str, lr: float, tensors) -> torch.optim.Optimizer:
    """torch.optim Adam or SGD (no momentum), with optax's defaults, over
    `tensors`."""
    if name == "adam":
        return torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(tensors, lr=lr)
    raise ValueError(f"unknown optimizer: {name}")


def initial_opt_state(name: str, params: dict, opt_keys) -> dict:
    """The optimizer state before its first step, {key: {name: tensor}}:
    Adam's zero moments and step count (as torch creates them), nothing
    for SGD.  Also the template that `load_state` restores into."""
    if name not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer: {name}")
    state = {}
    for k in opt_keys:
        p = params[k]
        state[k] = {} if name == "sgd" else {
            "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p),
            "step": torch.tensor(0.0),
        }
    return state


def _maybe_refit(accel, params, scene, cfg):
    """The quad accel refit to the current vertices.  'brute' needs no
    accel; every other accel-backed traversal has no refit and would select
    hits against the step-0 geometry, so vertex optimisation refuses it."""
    if cfg.traversal == "brute" or accel is None:
        return accel
    if cfg.traversal != "quad":
        raise ValueError(
            f"vertex optimisation with traversal={cfg.traversal!r} would "
            "run hit selection against a stale baked accel (refit is "
            "implemented for 'quad'; 'brute' needs none) - use "
            "traversal='quad' or 'brute'"
        )
    from dpt_tpu_torch.kernels.quad import refit_quad

    return refit_quad(accel, params["vertices"], scene.indices)


def optimize(
    scene,
    camera,
    cfg: RenderConfig,
    target,
    *,
    steps: int,
    lr: float = 1e-2,
    optimizer: str = "adam",
    opt_params: Sequence[str] = ("albedo",),
    micro_steps: int = 1,
    accel=None,
    backward: str = "tape",
    sharded: bool = False,
    checkpointer=None,
    checkpoint_every: int = 0,
    checkpoint_meta: Optional[dict] = None,
    on_step: Optional[Callable] = None,
    init_params=None,
    init_opt_state=None,
    start_step: int = 0,
    advance_seeds: bool = True,
):
    """Run steps start_step..steps-1; returns (params, opt_state, losses).

    params and opt_state are dicts of tensors (`split_params` keys;
    `initial_opt_state` layout).  Resume by passing the (init_params,
    init_opt_state, start_step) that `load_state` returns: the seed
    schedule is a pure function of the step, so the resumed run continues
    the uninterrupted one bit for bit.  advance_seeds=False reuses seeds
    0..micro_steps-1 every step, which makes the loss a deterministic
    function of the parameters (right when the target is one rendered
    batch).
    """
    opt_keys = tuple(opt_params)
    unknown = set(opt_keys) - set(OPTIMIZABLE)
    if unknown:
        raise ValueError(f"unknown opt params: {sorted(unknown)}")
    if micro_steps < 1:
        raise ValueError(f"micro_steps must be >= 1, got {micro_steps}")
    if steps < start_step:
        raise ValueError(f"steps ({steps}) < start_step ({start_step})")
    if backward not in ("tape", "replay"):
        raise ValueError(f"unknown backward: {backward!r}")
    do_refit = "vertices" in opt_keys

    src = init_params if init_params is not None else split_params(scene,
                                                                   camera)
    params = {k: v.detach().clone() for k, v in src.items()}
    opt = make_optimizer(optimizer, lr, [params[k] for k in opt_keys])
    state = (init_opt_state if init_opt_state is not None
             else initial_opt_state(optimizer, params, opt_keys))
    for k in opt_keys:
        opt.state[params[k]] = {n: v.clone() for n, v in state[k].items()}
    if sharded:
        from dpt_tpu_torch.dist import sharding

        lg = (sharding.sharded_tape_loss_and_grads if backward == "tape"
              else sharding.sharded_replay_loss_and_grads)
    else:
        lg = (tape_loss_and_grads if backward == "tape"
              else replay_loss_and_grads)

    losses = []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        acc_s = _maybe_refit(accel, params, scene, cfg) if do_refit else accel
        s, c = merge_params(params, scene, camera)
        loss_sum = None
        grad_sum = None
        for m in range(micro_steps):
            seed = (step * micro_steps + m) if advance_seeds else m
            loss, grads = lg(s, c, cfg, target, sample_batch=seed,
                             accel=acc_s)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            grad_sum = grads if grad_sum is None else {
                k: grad_sum[k] + grads[k] for k in grads}
        inv = 1.0 / micro_steps
        for k in opt_keys:
            params[k].grad = grad_sum[k] * inv
        opt.step()
        for k in opt_keys:
            params[k].grad = None
        loss_v = float(loss_sum) * inv
        losses.append(loss_v)
        dt = time.perf_counter() - t0
        if on_step is not None:
            on_step(step, loss_v, {"step_ms": dt * 1e3,
                                   "micro_steps": micro_steps})
        if checkpointer is not None and checkpoint_every and (
            (step + 1) % checkpoint_every == 0
        ):
            save_state(checkpointer, step + 1, params,
                       _opt_state(opt, params, opt_keys),
                       meta=checkpoint_meta)
    return params, _opt_state(opt, params, opt_keys), losses


def _opt_state(opt, params, opt_keys) -> dict:
    return {k: {n: v.detach().clone() for n, v in opt.state[params[k]].items()}
            for k in opt_keys}


def save_state(checkpointer, step: int, params, opt_state, meta=None):
    """Persist (step, params, optimizer state) as the checkpoint's extra
    leaves.  In a process group only rank 0 writes."""
    from dpt_tpu_torch.dist.sharding import world

    if world()[0] != 0:
        return
    extra = {"params": params, "opt_state": opt_state}
    checkpointer.save(np.zeros((0,), np.float32), step, extra=extra,
                      meta=meta)


def load_state(checkpointer, params_like, opt_state_like):
    """(step, params, opt_state) saved by save_state, or None.  The
    templates give the structure and devices (the npz stores flat
    leaves)."""
    loaded = checkpointer.load()
    if loaded is None:
        return None
    _, step, aux = loaded
    extra = aux["extra"]
    if not extra:
        return None
    template = {"params": params_like, "opt_state": opt_state_like}
    if len(extra) != len(flatten(template)):
        raise ValueError(f"checkpoint holds {len(extra)} leaves, the "
                         f"template {len(flatten(template))}")
    restored = unflatten(template, extra, device="cpu")
    return step, restored["params"], restored["opt_state"]
