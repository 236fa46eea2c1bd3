"""Inputs shared by tests/test_torch_dist.py and its rank processes
(tests/torch_dist_worker.py): configs, scenes and CLI arguments.  Imports
`dpt_tpu_torch` only, so the ranks never import jax."""

import dataclasses

import numpy as np
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.render.raygen import generate_rays
from dpt_tpu_torch.render.trace import make_nearest

SEED = 3
# The sharded render: the box at 16², the per-ray BVH walk (as the JAX
# package's tests/test_multiprocess.py renders it).
RENDER = T.RenderConfig(width=16, height=16, max_depth=2, spp=1,
                        traversal="bvh", bvh_builder="median",
                        bvh_leaf_size=2, enable_sss=True,
                        remat_bounces=False)
# The sharded gradients: the box at 8², brute search, compaction on.
GRAD = T.RenderConfig(width=8, height=8, max_depth=2, spp=1,
                      traversal="brute", enable_sss=False,
                      remat_bounces=False, compact_frac=0.25)
BACKWARDS = {"plain": "sharded_loss_and_grads",
             "replay": "sharded_replay_loss_and_grads",
             "tape": "sharded_tape_loss_and_grads"}
# Framings whose ranks differ in live lanes: the JAX package's
# divergent-branch sphere (tests/test_sharding.py), and the same sphere
# moved along +y so that rank 0's rows hit nothing at all.
DIVERGENT = ("sphere", "one_rank_empty")

CLI_RENDER = ["render", "--device", "cpu", "--width", "16", "--height",
              "16", "--bounces", "2", "--batches", "2", "--traversal", "bvh",
              "--bvh-builder", "median", "--leaf-size", "2"]


def cli_optimize(target):
    """`optimize` arguments (without --steps and --out)."""
    return ["optimize", "--device", "cpu", "--target", target, "--width",
            "16", "--height", "16", "--bounces", "2", "--spp", "1",
            "--no-sss", "--lr", "0.05", "--opt-params", "albedo",
            "--init-albedo", "0.4", "0.4", "0.4", "--fixed-seeds"]


def box():
    return (T.cornell_box_scene(device="cpu"),
            T.OrbitCamera().camera("cpu"))


def grad_arrays():
    """(albedo [1, 3], target [8, 8, 3]) from a numpy seed."""
    rng = np.random.default_rng(7)
    albedo = rng.uniform(0.3, 0.9, (1, 3)).astype(np.float32)
    target = rng.uniform(0.0, 0.5, (GRAD.height, GRAD.width, 3)).astype(
        np.float32)
    return albedo, target


def grad_inputs():
    """(scene, camera, target) of the sharded gradients."""
    albedo, target = grad_arrays()
    scene, camera = box()
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo=torch.as_tensor(albedo)))
    return scene, camera, torch.as_tensor(target)


def divergent(case):
    """(scene, camera, cfg) of one DIVERGENT framing."""
    scene = T.procedural_scene(n_tris_target=300, device="cpu")
    cfg = T.RenderConfig(width=32, height=64, max_depth=2, spp=1,
                         traversal="bvh", bvh_builder="median",
                         bvh_leaf_size=4, enable_sss=True, sss_bounces=1,
                         remat_bounces=False, compact_frac=0.5)
    if case == "one_rank_empty":
        shift = torch.tensor([0.0, 1.6, 0.0])
        scene = dataclasses.replace(scene, vertices=scene.vertices + shift)
    return scene, T.OrbitCamera().camera("cpu"), cfg


def live_lanes(scene, camera, cfg, accel, first, end):
    """Primary hits in rows [first, end) of sample batch 0."""
    o, d, _ = generate_rays(camera, cfg, 0)
    hit = make_nearest(scene, cfg, accel)(o, d)["hit"]
    return int(hit.reshape(cfg.height, cfg.width)[first:end].sum())
