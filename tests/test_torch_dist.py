"""dpt_tpu_torch over two processes (dist/sharding.py, the CLI's
multi-process options, entry.dryrun_multichip's rank body) ≡ one process
≡ dpt_tpu.

One spawn for the whole file: two `gloo` CPU ranks of
tests/torch_dist_worker.py (which imports dpt_tpu_torch only, never jax),
each with its own time limit (dist/launch.run_ranks); they save what they
computed and the tests here hold it against the port in this process and
against the JAX package:

  - the sharded box render, gathered on each rank, ≡ the port's single
    render ≡ JAX `render_sample` (rtol 1e-5, atol 1e-6: the tolerance of
    tests/test_multiprocess.py);
  - sharded plain, replay and tape gradients ≡ JAX `tape_loss_and_grads`
    (rtol 1e-4, atol 1e-6, as tests/test_sharding.py holds JAX's);
  - two framings whose ranks differ in live lanes (one with a rank that
    has none) finish, and match the single process's tape gradients;
  - the CLI's `render --sharded` and `optimize --sharded` over two ranks ≡
    the single-process CLI (the tolerances of
    tests/test_multiprocess_cli.py), and an `optimize` resumed from a
    checkpoint that only rank 0 has resumes on both ranks;
  - `entry.dryrun_rank`: a finite sharded tape step, sharded ≡ single.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch import cli
from dpt_tpu_torch.accel.bvh import build_accel
from dpt_tpu_torch.diff import grads as G
from dpt_tpu_torch.dist import sharding as S
from dpt_tpu_torch.dist.launch import free_port, run_ranks

import torch_dist_cases as C

torch.set_num_threads(2)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dist_worker.py")
RANKS = 2
RANK_TIMEOUT = 240


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import dpt_tpu
    from dpt_tpu.accel.bvh import build_accel as j_build_accel
    from dpt_tpu.diff import grads
    from dpt_tpu.render import renderer

    return types.SimpleNamespace(jnp=jnp, pkg=dpt_tpu, grads=grads,
                                 renderer=renderer,
                                 build_accel=j_build_accel)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two ranks once: (outdir, [rank 0's results, rank 1's])."""
    out = tmp_path_factory.mktemp("dist")
    cli.main(["render", "--device", "cpu", "--width", "16", "--height", "16",
              "--bounces", "2", "--spp", "1", "--no-sss", "--batches", "1",
              "--out", str(out / "target.npy"),
              "--metrics", str(out / "target.jsonl")])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = free_port()
    run_ranks([[sys.executable, WORKER, str(r), str(RANKS), str(port),
                str(out)] for r in range(RANKS)], RANK_TIMEOUT, env=env)
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]


def test_backend_rule(monkeypatch):
    assert S.backend_for("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert S.backend_for("cuda", 2) == "nccl"  # a card per rank
    assert S.backend_for("cuda:0", 3) == "gloo"  # ranks share cards
    assert S.rank_device("cuda", 3) == torch.device("cuda", 1)
    assert S.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert S.rank_device("cpu", 1) == torch.device("cpu")
    assert S.init_distributed(None, 1, 0, "cpu") is None
    assert S.world() == (0, 1)


def test_backend_rule_counts_the_ranks_of_this_machine(monkeypatch):
    """The rule reads the ranks on this machine (LOCAL_WORLD_SIZE /
    LOCAL_RANK), not the world size: 2 machines x 8 cards (world size 16)
    get nccl and card LOCAL_RANK; 2 ranks sharing 1 card get gloo.  Decided
    before any init."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert S.backend_for("cuda", 16) == "nccl"
    assert S.rank_device("cuda", 11) == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert S.backend_for("cuda", 2) == "gloo"
    assert S.rank_device("cuda", 1) == torch.device("cuda", 0)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.delenv("LOCAL_RANK")
    assert S.backend_for("cuda", 2) == "gloo"
    assert S.world() == (0, 1)


def test_rank_rows_cover_the_frame():
    cfg = T.RenderConfig(width=5, height=12)
    from dpt_tpu_torch.render.raygen import pixel_grid

    px, py = pixel_grid(cfg, "cpu")
    parts = [S.rank_pixels(cfg, r, 3, "cpu") for r in range(3)]
    assert torch.equal(torch.cat([p[0] for p in parts]), px)
    assert torch.equal(torch.cat([p[1] for p in parts]), py)
    assert S.rank_rows(cfg, 2, 3) == (8, 12)
    with pytest.raises(ValueError, match="divide"):
        S.rank_rows(cfg, 0, 5)


def test_sharded_render_matches_single_and_jax(ranks, jx):
    _, res = ranks
    scene, camera = C.box()
    single = T.render_sample(scene, camera, C.RENDER, 0,
                             build_accel(scene, C.RENDER)).numpy()
    jcfg = jx.pkg.RenderConfig(**{f: getattr(C.RENDER, f)
                                  for f in ("width", "height", "max_depth",
                                            "spp", "traversal",
                                            "bvh_builder", "bvh_leaf_size",
                                            "enable_sss", "remat_bounces")})
    jscene = jx.pkg.cornell_box_scene()
    ref = np.asarray(jx.renderer.render_sample(
        jscene, jx.pkg.OrbitCamera().camera(), jcfg, jx.jnp.uint32(0),
        jx.build_accel(jscene, jcfg)))
    assert float(single.max()) > 0.0
    for r in range(RANKS):
        np.testing.assert_allclose(res[r]["render"], single, rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(res[r]["render"], ref, rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r} vs jax")


@pytest.fixture(scope="module")
def jax_grad_ref(jx):
    """JAX `tape_loss_and_grads` of the sharded gradients' inputs."""
    import dataclasses

    albedo, target = C.grad_arrays()
    js = jx.pkg.cornell_box_scene()
    js = dataclasses.replace(js, materials=dataclasses.replace(
        js.materials, albedo=jx.jnp.asarray(albedo)))
    jcfg = jx.pkg.RenderConfig(**{f: getattr(C.GRAD, f) for f in (
        "width", "height", "max_depth", "spp", "traversal", "enable_sss",
        "remat_bounces", "compact_frac")})
    return jx.grads.tape_loss_and_grads(
        js, jx.pkg.OrbitCamera().camera(), jcfg, jx.jnp.asarray(target),
        sample_batch=C.SEED)


@pytest.mark.parametrize("backward", sorted(C.BACKWARDS))
def test_sharded_grads_match_jax(ranks, jax_grad_ref, backward):
    _, res = ranks
    loss_ref, grads_ref = jax_grad_ref
    for r in range(RANKS):
        np.testing.assert_allclose(res[r][f"{backward}_loss"],
                                   np.asarray(loss_ref), rtol=1e-4,
                                   atol=1e-6)
        for k in G.PARAM_KEYS:
            got = res[r][f"{backward}_{k}"]
            assert np.isfinite(got).all(), k
            np.testing.assert_allclose(got, np.asarray(grads_ref[k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {backward} {k}")


@pytest.mark.parametrize("case", C.DIVERGENT)
def test_divergent_ranks_finish_and_match(ranks, case):
    _, res = ranks
    n_live = [int(res[r][f"{case}_n_live"]) for r in range(RANKS)]
    assert n_live[0] != n_live[1], n_live
    if case == "one_rank_empty":
        assert n_live[0] == 0 < n_live[1], n_live
    scene, camera, cfg = C.divergent(case)
    loss, grads = G.tape_loss_and_grads(
        scene, camera, cfg, torch.zeros((cfg.height, cfg.width, 3)), 0,
        build_accel(scene, cfg))
    for r in range(RANKS):
        np.testing.assert_allclose(res[r][f"{case}_loss"], loss.numpy(),
                                   rtol=1e-5)
        for k in G.PARAM_KEYS:
            g = grads[k].numpy()
            scale = max(float(np.abs(g).max()), 1e-12)
            np.testing.assert_allclose(res[r][f"{case}_{k}"], g, rtol=1e-4,
                                       atol=1e-6 * scale,
                                       err_msg=f"rank {r} {case} {k}")


def test_cli_render_two_ranks(ranks):
    out, res = ranks
    ref = cli.main([*C.CLI_RENDER, "--out", str(out / "single.npy"),
                    "--metrics", str(out / "single.jsonl")]).numpy()
    np.testing.assert_allclose(np.load(out / "cli.npy"), ref, rtol=1e-5,
                               atol=1e-6)
    for r in range(RANKS):
        np.testing.assert_array_equal(res[r]["cli_render"],
                                      np.load(out / "cli.npy"))
    rows = [json.loads(x) for x in (out / "cli.jsonl").read_text()
            .splitlines()]
    assert [(x["rank"], x["world_size"], x["backend"], x["batch"])
            for x in rows] == [(0, 2, "gloo", 0), (0, 2, "gloo", 1)]


def _single_optimize(out, steps):
    params, _ = cli.main([*C.cli_optimize(str(out / "target.npy")),
                          "--steps", str(steps), "--out",
                          str(out / f"single{steps}.npz"),
                          "--metrics", str(out / "single_opt.jsonl")])
    return params["albedo"].numpy()


def test_cli_optimize_two_ranks(ranks):
    out, _ = ranks
    np.testing.assert_allclose(np.load(out / "opt2.npz")["albedo"],
                               _single_optimize(out, 2), rtol=1e-5,
                               atol=1e-7)


def test_cli_optimize_resume_from_rank0_checkpoint(ranks):
    """Only rank 0 wrote a checkpoint; both ranks resume from it (the JAX
    package reads the file on each process, and a process without it
    would start over), run step 2 alone, and agree."""
    out, res = ranks
    assert (out / "ck_0.npz").exists() and not (out / "ck_1.npz").exists()
    for r in range(RANKS):
        assert res[r]["resumed_losses"].shape == (1,)
        np.testing.assert_array_equal(res[r]["resumed_losses"],
                                      res[0]["resumed_losses"])
        np.testing.assert_array_equal(res[r]["resumed_albedo"],
                                      res[0]["resumed_albedo"])
    np.testing.assert_allclose(np.load(out / "opt3.npz")["albedo"],
                               _single_optimize(out, 3), rtol=1e-5,
                               atol=1e-7)


def test_dryrun_rank(ranks):
    _, res = ranks
    runs = [json.loads(str(res[r]["dryrun"])) for r in range(RANKS)]
    assert np.isfinite(runs[0]["loss"]) and runs[0]["loss"] == runs[1]["loss"]
    assert all(x["max_abs_diff"] <= 1e-5 for x in runs)
