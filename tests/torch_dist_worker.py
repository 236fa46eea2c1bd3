"""One rank of tests/test_torch_dist.py: two `gloo` CPU ranks of the port.

Usage: python tests/torch_dist_worker.py <rank> <ranks> <port> <outdir>

Imports `dpt_tpu_torch` only (never jax).  Joins the process group, then
runs, in the same order on every rank, each check that needs more than one
rank, and saves what it got to <outdir>/rank<rank>.npz (the CLI runs write
their files from rank 0 only); the test holds them against a single
process and against dpt_tpu.
"""

import json
import os
import sys

import numpy as np
import torch

rank, ranks, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                             int(sys.argv[3]), sys.argv[4])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
torch.set_num_threads(1)

from dpt_tpu_torch import cli, entry  # noqa: E402
from dpt_tpu_torch.accel.bvh import build_accel  # noqa: E402
from dpt_tpu_torch.diff.grads import PARAM_KEYS  # noqa: E402
from dpt_tpu_torch.dist import sharding as S  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_cases as C  # noqa: E402

addr = f"localhost:{port}"
assert S.init_distributed(addr, ranks, rank, "cpu") == "gloo"
# Idempotent, as the CLI calls it again with the group up.
assert S.init_distributed(addr, ranks, rank, "cpu") == "gloo"
assert S.world() == (rank, ranks)
out = {}

# Sharded render of the box, gathered on every rank.
scene, camera = C.box()
cfg = C.RENDER
accel = build_accel(scene, cfg)
block = S.render_sample_sharded(scene, camera, cfg, 0, accel)
assert block.shape == (cfg.height // ranks, cfg.width, 3)
out["render"] = S.gather_image(block).numpy()

# Sharded plain / replay / tape gradients of the box.
scene, camera, target = C.grad_inputs()
for name in C.BACKWARDS:
    fn = getattr(S, C.BACKWARDS[name])
    loss, grads = fn(scene, camera, C.GRAD, target, sample_batch=C.SEED)
    out[f"{name}_loss"] = loss.numpy()
    for k in PARAM_KEYS:
        out[f"{name}_{k}"] = grads[k].numpy()

# Ranks that differ in live lanes: each compacts to its own count.
for case in C.DIVERGENT:
    scene, camera, cfg = C.divergent(case)
    accel = build_accel(scene, cfg)
    first, end = S.rank_rows(cfg, rank, ranks)
    out[f"{case}_n_live"] = np.int64(C.live_lanes(scene, camera, cfg, accel,
                                                  first, end))
    target = torch.zeros((cfg.height, cfg.width, 3))
    loss, grads = S.sharded_tape_loss_and_grads(scene, camera, cfg, target,
                                                0, accel)
    out[f"{case}_loss"] = loss.numpy()
    for k in PARAM_KEYS:
        out[f"{case}_{k}"] = grads[k].numpy()

# The CLI over the two ranks: render, optimize, optimize resumed from a
# checkpoint only rank 0 has.
mp = ["--sharded", "--num-processes", str(ranks), "--process-id", str(rank),
      "--coordinator", addr]
img = cli.main([*C.CLI_RENDER, *mp, "--out", os.path.join(outdir, "cli.npy"),
                "--metrics", os.path.join(outdir, "cli.jsonl")])
out["cli_render"] = img.numpy()
target = os.path.join(outdir, "target.npy")
own = os.path.join(outdir, f"ck_{rank}.npz")
opt = [*C.cli_optimize(target), *mp, "--checkpoint", own,
       "--metrics", os.path.join(outdir, "opt.jsonl")]
cli.main([*opt, "--steps", "2", "--out", os.path.join(outdir, "opt2.npz")])
if rank != 0:  # only rank 0 keeps a checkpoint
    assert not os.path.exists(own)
params, losses = cli.main([*opt, "--steps", "3",
                           "--out", os.path.join(outdir, "opt3.npz")])
out["resumed_losses"] = np.asarray(losses)
out["resumed_albedo"] = params["albedo"].numpy()

# entry.dryrun_multichip's rank body.
out["dryrun"] = np.asarray(json.dumps(entry.dryrun_rank("cpu")))

np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
print(f"rank {rank} of {ranks} done", flush=True)
