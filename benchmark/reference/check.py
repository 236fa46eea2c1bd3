"""The comparison that decides `correct`.

It runs once the window has closed, on the program's outputs that the
window kept, against the plain reference (tracer.py) given the same
inputs: the mesh, lights, material, camera and sample batches.

- A "progressive" window: for each checked unit (a batch or a frame),
  the sample the program produced (what `render_sample` returned), on
  rows of the frame drawn from the seed, beside the reference's sample of
  the same rows: `px_off`, the share of pixel channels off by more than
  2e-3 + 1e-3 * |reference| (the repo's image tolerance), which a pixel
  whose path takes another triangle at an edge moves by one pixel's
  share alone.  And the
  accumulation: the program's image after the unit beside the running
  mean (raytrace_comp.comp:467-469) of its image before and that sample,
  worked out here: `acc_err`, the largest |difference| over
  max(|expected|, 1e-3).  (This follows the program from its own state;
  its start, batch 0 over a zero image, and the samples it takes are
  checked by themselves.)  The numbers compared are the largest over the
  units.
- An "optimize" window: the reference renders the target and follows the
  first steps over the whole frame in row blocks, with autograd for the
  albedo and its own Adam.  `loss_gap`: the largest over those steps of
  |loss - reference| / reference; `grad_gap`: the gap between the norms
  of the first gradient (the program's from Adam's first moment after one
  step) over the reference's norm; `step_gap`: the same of the change of
  the albedo over the steps.  Then it repeats the window's last step from
  the program's state before it (the albedo, Adam's moments and step
  count), as `acc_err` repeats the running mean: `last_loss_gap`,
  `last_grad_gap` and `last_step_gap` are the same gaps of that step's
  loss, gradient and change of the albedo.

`q` makes the reference's control: the same comparison with the
reference, in bfloat16 on its radiance path, in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tracer

TOL_ABS = 2e-3
TOL_REL = 1e-3


def reference_scene(inputs, device):
    return tracer.Scene(torch.as_tensor(inputs["vertices"], device=device),
                        torch.as_tensor(inputs["indices"], device=device),
                        inputs["material"], inputs["lights"],
                        inputs["settings"])


def check_rows(seed, unit, height, n):
    rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 5, unit])
    return torch.as_tensor(np.sort(rng.choice(height, size=min(n, height),
                                              replace=False)))


def _px_off(prog, ref):
    return float(((prog - ref).abs() > TOL_ABS + TOL_REL * ref.abs())
                 .float().mean())


def _acc_err(image, expected):
    return float(((image - expected).abs()
                  / torch.clamp(expected.abs(), min=1e-3)).max())


def progressive(inputs, outputs, seed, n_rows, device, q=None):
    """Numbers of a progressive window.  outputs: "units", "samples" and
    "images" (the program's, per unit), "batches", "cameras",
    "accumulates".  With `q`, the reference in that precision gives the
    samples and the running mean in the program's place."""
    ref = reference_scene(inputs, device)
    H = inputs["settings"]["height"]
    per_unit = {}
    for u in outputs["units"]:
        rows = check_rows(seed, u, H, n_rows).to(device)
        cam, b = outputs["cameras"][u], outputs["batches"][u]
        sample = outputs["samples"][u].detach().reshape(H, -1, 3)
        acc = outputs["accumulates"] and u > 0
        prev = (outputs["images"][u - 1].detach() if acc
                else torch.zeros_like(sample))
        n = u if acc else 0
        expected = tracer.accumulate(prev, sample, n)
        with torch.no_grad():
            want = ref.render(cam, b, rows)
            if q is None:
                got = sample[rows].reshape(-1, 3)
                image = outputs["images"][u].detach()
            else:
                got = ref.render(cam, b, rows, q=q)
                image = tracer.accumulate(prev, sample, n, q)
        per_unit[u] = {"px_off": _px_off(got, want),
                       "acc_err": _acc_err(image, expected)}
    numbers = {k: max(n[k] for n in per_unit.values())
               for k in ("px_off", "acc_err")}
    return numbers, per_unit


def _frame_loss(ref, camera, batch, albedo, target, q, blocks):
    """The L2 loss of the whole frame and its gradient for the albedo,
    over row blocks; target None renders the image instead of a loss."""
    H, W = ref.s["height"], ref.s["width"]
    a = albedo.detach().clone().requires_grad_(True)
    loss = 0.0
    image = []
    for rows in blocks:
        rows = rows.to(a.device)
        if target is None:
            with torch.no_grad():
                image.append(ref.render(camera, batch, rows, a, q))
            continue
        img = ref.render(camera, batch, rows, a, q)
        t = target[rows].reshape(-1, 3)
        part = ((img - t) ** 2).sum() / (H * W * 3)
        part.backward()
        loss += float(part.detach())
    if target is None:
        return torch.cat(image).reshape(H, W, 3)
    return loss, a.grad.detach().clone()


def _follow(inputs, outputs, mix, device, q):
    """The reference's own target and first steps from the same start, and
    the window's last step from the program's state before it: (losses,
    first gradient, change of the albedo, last loss, last gradient, last
    change)."""
    ref = reference_scene(inputs, device)
    s = ref.s
    blocks = tracer.row_blocks(s["height"], s["width"],
                               mix.get("check_block_pixels", 1 << 19))
    camera = outputs["camera"]
    target = _frame_loss(ref, camera, outputs["target_batch"],
                         ref.material["albedo"], None, q, blocks)
    start = _flat(outputs["start"], device)
    a = start.clone()
    m = torch.zeros_like(a)
    v = torch.zeros_like(a)
    losses, first = [], None
    for k, b in enumerate(outputs["batches"]):
        loss, g = _frame_loss(ref, camera, b, a, target, q, blocks)
        losses.append(loss)
        if k == 0:
            first = g
        a, m, v = tracer.adam(a, g, m, v, k + 1, mix["lr"])
    last = outputs["last"]
    before = _flat(last["albedo"], device)
    last_loss, g = _frame_loss(ref, camera, last["batch"], before, target,
                               q, blocks)
    after, _, _ = tracer.adam(before, g, _flat(last["m"], device),
                              _flat(last["v"], device), last["step"] + 1,
                              mix["lr"])
    return losses, first, a - start, last_loss, g, after - before


def _flat(x, device):
    return x.detach().reshape(-1).float().to(device)


def optimize(inputs, outputs, mix, device, q=None):
    """Numbers of an optimize window.  outputs: "losses", "first_grad",
    "start", "after" (of the albedo), "camera", "target_batch", "batches",
    and "last": the window's last step ("albedo", "m", "v", "step" before
    it, "batch", and its "loss", "grad" and the albedo "after").  With
    `q`, the reference in that precision takes the program's place."""
    want = _follow(inputs, outputs, mix, device, tracer.exact)
    if q is None:
        last = outputs["last"]
        got = (outputs["losses"], _flat(outputs["first_grad"], device),
               _flat(outputs["after"], device)
               - _flat(outputs["start"], device),
               last["loss"], _flat(last["grad"], device),
               _flat(last["after"], device) - _flat(last["albedo"], device))
    else:
        got = _follow(inputs, outputs, mix, device, q)

    def gap(x, y):
        ny = float(torch.linalg.vector_norm(y))
        return abs(float(torch.linalg.vector_norm(x)) - ny) / max(ny, 1e-30)

    def rel(x, y):
        return abs(x - y) / max(abs(y), 1e-30)

    numbers = {
        "loss_gap": max(rel(x, y) for x, y in zip(got[0], want[0])),
        "grad_gap": gap(got[1], want[1]),
        "step_gap": gap(got[2], want[2]),
        "last_loss_gap": rel(got[3], want[3]),
        "last_grad_gap": gap(got[4], want[4]),
        "last_step_gap": gap(got[5], want[5]),
    }
    detail = {"losses": list(got[0]), "ref_losses": want[0],
              "grad": got[1].tolist(), "ref_grad": want[1].tolist(),
              "step": got[2].tolist(), "ref_step": want[2].tolist(),
              "last_loss": got[3], "ref_last_loss": want[3],
              "last_grad": got[4].tolist(), "ref_last_grad": want[4].tolist(),
              "last_step": got[5].tolist(), "ref_last_step": want[5].tolist(),
              "last_batch": outputs["last"]["batch"],
              "last_adam_step": outputs["last"]["step"] + 1}
    return numbers, detail
