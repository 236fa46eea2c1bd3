"""dpt_tpu_torch — the PyTorch/CUDA port of `dpt_tpu`.

A second package beside the JAX one, with the same layout and module names,
checked against it (tests/test_torch_*.py).  It renders the flagship forward
path: procedural mesh, SAH BVH packed 4-wide (or paired-children), raygen
with DoF and AA, primary trace shared with the direct-view light pass,
carry compaction, and bounces with NEE, SSS walk and a cosine bounce, with
every query after the primary coherence-sorted.  It differentiates that
render (diff/grads.py: tape, replay and plain backwards) and drives inverse
rendering (diff/optimize.py, `cli optimize`).  The box-scale path
(`traversal="brute", kernels="intersect"`: the reference's box, progressive
with checkpoints, `cli interactive`) runs the brute-force search.  The BVH
walks and the brute-force search run as hand-written CUDA kernels on the
card (csrc/quad_traverse.cu, csrc/wide_traverse.cu,
csrc/intersect_nearest.cu) and as their plain PyTorch versions on the CPU.
OBJ scenes load with `load_scene`.  Renders and optimisation split
their pixel rows over the ranks of a torch.distributed group
(dist/sharding.py, the CLI's --sharded); the LBVH builds on the render
device (accel/lbvh.py); `bvh`, `packet` and `threaded` take the per-ray
stack walk in torch ops (accel/traverse.py); entry.py holds the driver
entry points.  Entry points default to the card (`device="cuda"`).

It imports torch and numpy only, never jax or dpt_tpu.
"""

from dpt_tpu_torch.config import PRESETS, RenderConfig, preset
from dpt_tpu_torch.render.renderer import (
    accumulate,
    render,
    render_progressive,
    render_sample,
)
from dpt_tpu_torch.scene.builder import (
    cornell_box_scene,
    knot_scene,
    load_scene,
    procedural_scene,
)
from dpt_tpu_torch.scene.camera import Camera, OrbitCamera
from dpt_tpu_torch.scene.scene import (
    Lights,
    Materials,
    Scene,
    default_lights,
    make_area_lights,
)

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "PRESETS",
    "preset",
    "Scene",
    "Materials",
    "Lights",
    "make_area_lights",
    "default_lights",
    "OrbitCamera",
    "Camera",
    "cornell_box_scene",
    "procedural_scene",
    "knot_scene",
    "load_scene",
    "render",
    "render_sample",
    "render_progressive",
    "accumulate",
]
