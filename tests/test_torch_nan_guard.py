"""NaN sanitation of the port: the twin of tests/test_nan_guard.py.

The JAX test renders under `jax_debug_nans`, which checks every op's
output.  Here the same render runs on the CPU under a TorchDispatchMode
(`NanGuard`) that checks the floating outputs of every aten op and raises
on the first NaN; a tape step runs under `torch.autograd.detect_anomaly`,
which raises on a NaN from any backward function; and a deliberate 0/0
proves the guard fires, so the render test cannot pass vacuously.

One exemption, by design: the plain quad walk's NaN-boxed empty slots
(ROADMAP hazards).  The 4-wide table holds NaN boxes for empty slots, so
in `kernels/quad.py` `_walk_reference` the views of the table, the
records gathered from it and their lanes (data movement only: view,
index, select, slice) carry NaN, and so do the slab values `_slab`
computes from them, which the NaN-propagating min / max keep out of every
hit.  A NaN is allowed only where the innermost frame of the port that
made it is `_slab`, or `_walk_reference` moving data.
"""

import pathlib
import traceback

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import dpt_tpu_torch as T
from dpt_tpu_torch.accel.bvh import build_accel
from dpt_tpu_torch.diff import grads as G
from dpt_tpu_torch.render.renderer import render_sample

CPU = torch.device("cpu")
PKG = pathlib.Path(T.__file__).resolve().parent
QUAD = str(PKG / "kernels" / "quad.py")


# The ops that only move the walk's table and records (no arithmetic).
aten = torch.ops.aten
MOVES = {aten.view.default, aten.index.Tensor, aten.select.int,
         aten.slice.Tensor}


def _slab_exempt(func):
    """Whether the op now dispatching makes one of the plain quad walk's
    NaN-boxed slab tensors: the innermost port frame is `_slab`, or is
    `_walk_reference` moving the table or its records (MOVES)."""
    for frame in reversed(traceback.extract_stack()):
        if not frame.filename.startswith(str(PKG)):
            continue
        if frame.filename != QUAD:
            return False
        return frame.name == "_slab" or (
            frame.name == "_walk_reference" and func in MOVES)
    return False


class NanGuard(TorchDispatchMode):
    """Raise FloatingPointError on the first NaN in a floating output of
    any aten op, but for `_slab_exempt`.  `checked` counts the floating
    outputs seen, `exempt` the NaN outputs let through."""

    def __init__(self):
        super().__init__()
        self.checked = 0
        self.exempt = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                continue
            self.checked += 1
            if bool(torch.isnan(t).any()):
                if _slab_exempt(func):
                    self.exempt += 1
                    continue
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


def _scene_cfg():
    """tests/test_nan_guard.py's render: the box, 16², depth 3, SSS,
    Russian roulette, depth of field (the default aperture), the wavefront
    sort and the quad walk over a SAH tree of leaf 4."""
    scene = T.cornell_box_scene(device=CPU)
    cfg = T.RenderConfig(
        width=16, height=16, max_depth=3, spp=1, traversal="quad",
        bvh_builder="sah", bvh_leaf_size=4, packet_tile=256,
        wavefront_sort=True, enable_sss=True, russian_roulette=True,
    )
    assert cfg.aperture > 0
    return scene, cfg, build_accel(scene, cfg), T.OrbitCamera().camera(CPU)


def test_render_nan_free_under_guard():
    """The full-featured render completes under NanGuard: no op of the
    product path emits NaN outside the walk's empty slots, which do occur
    (the exemption is not idle)."""
    scene, cfg, accel, cam = _scene_cfg()
    guard = NanGuard()
    with guard:
        img = render_sample(scene, cam, cfg, 0, accel)
    assert guard.checked > 1000
    assert guard.exempt > 0
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())


def test_tape_step_under_detect_anomaly():
    """One tape step (forward recording the tape, backward over the
    playback) under detect_anomaly: no backward function returns NaN, and
    every gradient is finite."""
    scene, cfg, accel, cam = _scene_cfg()
    target = torch.full((16, 16, 3), 0.25)
    with torch.autograd.detect_anomaly():
        loss, grads = G.tape_loss_and_grads(scene, cam, cfg, target, 0,
                                            accel)
    assert bool(torch.isfinite(loss))
    assert grads and all(bool(torch.isfinite(g).all())
                         for g in grads.values())


def test_guard_is_live():
    """The guard fires: 0/0 under NanGuard raises, outside the walk."""
    z = torch.zeros(())
    with pytest.raises(FloatingPointError):
        with NanGuard():
            z / z


def test_detect_anomaly_is_live():
    """detect_anomaly fires on a backward that makes NaN (sqrt at 0 times
    0)."""
    x = torch.zeros((), requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with torch.autograd.detect_anomaly():
            (torch.sqrt(x) * 0.0).backward()
