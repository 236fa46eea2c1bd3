"""dpt_tpu_torch inverse rendering: refit, `optimize`, checkpoints
and the `optimize` CLI ≡ dpt_tpu.

  - `refit_quad` with unchanged vertices equals `pack_quad`, and after
    moved vertices it equals the JAX refit, both exactly as
    np.testing.assert_array_equal compares (NaN boxes match, 0.0 == -0.0:
    a min over tied signed zeros may keep either).
  - A two-step albedo optimisation is allclose to JAX `optimize`: losses at
    rtol 1e-5, albedo at rtol 1e-5 / atol 1e-6 (torch's and optax's Adam
    round in another order).
  - A resumed run continues the uninterrupted one bit for bit; frozen
    parameters stay bitwise; vertex optimisation refuses an accel it
    cannot refit; bad step counts raise.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch import cli
from dpt_tpu_torch.accel.bvh import build_accel
from dpt_tpu_torch.diff import optimize as O
from dpt_tpu_torch.diff.grads import split_params
from dpt_tpu_torch.kernels import quad as tq
from dpt_tpu_torch.utils import convert
from dpt_tpu_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(2)
CPU = "cpu"
CFG = T.RenderConfig(width=8, height=8, max_depth=2, spp=1,
                     traversal="brute", enable_sss=False,
                     remat_bounces=False)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import dpt_tpu
    from dpt_tpu.diff import optimize
    from dpt_tpu.kernels import pallas_quad
    from dpt_tpu.utils import checkpoint

    return types.SimpleNamespace(jnp=jnp, pkg=dpt_tpu, optimize=optimize,
                                 quad=pallas_quad, checkpoint=checkpoint)


def _with_albedo(scene, albedo):
    a = torch.tensor(albedo, dtype=torch.float32).expand_as(
        scene.materials.albedo).contiguous()
    return dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo=a))


@pytest.fixture(scope="module")
def box():
    scene = T.cornell_box_scene(device=CPU)
    camera = T.OrbitCamera(yaw=20.0).camera(CPU)
    target = T.render_sample(scene, camera, CFG, 0)
    return scene, camera, target, _with_albedo(scene, (0.4, 0.4, 0.4))


def _sphere(n=600):
    scene = T.procedural_scene(n_tris_target=n, device=CPU)
    cfg = T.RenderConfig(width=8, height=8, max_depth=2, spp=1,
                         traversal="quad", bvh_builder="sah",
                         bvh_leaf_size=8, ray_sort=True, enable_sss=False,
                         remat_bounces=False)
    return scene, cfg


def test_refit_quad_bitwise(jx):
    scene, cfg = _sphere()
    acc = build_accel(scene, cfg)
    same = tq.refit_quad(acc, scene.vertices, scene.indices)
    # Equal as np.testing.assert_array_equal has it, as the JAX package's
    # test_refit_identity does: NaN boxes match, and 0.0 == -0.0.
    np.testing.assert_array_equal(same.nodes_flat.numpy(),
                                  acc.nodes_flat.numpy())
    np.testing.assert_array_equal(same.tris.numpy(), acc.tris.numpy())

    rng = np.random.default_rng(3)
    v = scene.vertices.numpy()
    moved = (v + 0.03 * rng.normal(size=v.shape)).astype(np.float32)
    got = tq.refit_quad(acc, torch.as_tensor(moved), scene.indices)
    j_acc = convert_to_jax_quad(jx, acc)
    ref = jx.quad.refit_quad(j_acc, jx.jnp.asarray(moved),
                             jx.jnp.asarray(scene.indices.numpy()))
    np.testing.assert_array_equal(got.nodes_flat.numpy(),
                                  np.asarray(ref.nodes_flat))
    np.testing.assert_array_equal(got.tris.numpy(), np.asarray(ref.tris))
    # The refit tables select the moved mesh's hits.
    ms = dataclasses.replace(scene, vertices=torch.as_tensor(moved))
    o = torch.as_tensor(rng.normal(size=(256, 3)).astype(np.float32) * 2)
    d = torch.nn.functional.normalize(-o + 0.2 * torch.as_tensor(
        rng.normal(size=(256, 3)).astype(np.float32)), dim=1)
    from dpt_tpu_torch.render.intersect import brute_force_nearest

    bh, bt, _, _, _ = brute_force_nearest(o, d, *ms.tri_vertices())
    qh, qt, _ = tq.quad_nearest(o, d, got, cfg)
    assert torch.equal(bh, qh) and bh.any()
    np.testing.assert_allclose(qt[bh].numpy(), bt[bh].numpy(), rtol=1e-5,
                               atol=1e-6)


def convert_to_jax_quad(jx, acc):
    """The port's QuadAccel as the JAX package's (with its row layout)."""
    flat = acc.nodes_flat.numpy().reshape(-1, 32)
    pad = np.zeros(((-len(flat)) % 4, 32), np.float32)
    pad[:, :24] = np.nan
    rows = np.concatenate([flat, pad]).reshape(-1, 128)
    return jx.quad.QuadAccel(
        nodes=jx.jnp.asarray(rows), nodes_flat=jx.jnp.asarray(flat.ravel()),
        tris=jx.jnp.asarray(acc.tris.numpy()), n_wide=acc.n_wide,
        max_depth=acc.max_depth)


def test_two_step_albedo_matches_jax(jx, box):
    scene, camera, target, start = box
    ref_p, _, ref_l = jx.optimize.optimize(
        jx.pkg.cornell_box_scene(), jx.pkg.OrbitCamera(yaw=20.0).camera(),
        jx.pkg.RenderConfig(**dataclasses.asdict(CFG)),
        jx.jnp.asarray(target.numpy()), steps=2, lr=0.05,
        opt_params=("albedo",), backward="tape",
        init_params={**{k: jx.jnp.asarray(v.numpy()) for k, v in
                        split_params(start, camera).items()}},
    )
    params, _, losses = O.optimize(start, camera, CFG, target, steps=2,
                                   lr=0.05, opt_params=("albedo",))
    np.testing.assert_allclose(losses, ref_l, rtol=1e-5)
    np.testing.assert_allclose(params["albedo"].numpy(),
                               np.asarray(ref_p["albedo"]), rtol=1e-5,
                               atol=1e-6)
    assert not torch.equal(params["albedo"], start.materials.albedo)


def test_resume_continues_bit_for_bit(jx, box, tmp_path):
    scene, camera, target, start = box
    kw = dict(lr=0.05, opt_params=("albedo", "light_intensity"),
              micro_steps=2)
    p_full, s_full, l_full = O.optimize(start, camera, CFG, target, steps=4,
                                        **kw)
    ck = Checkpointer(str(tmp_path / "opt.npz"))
    p_half, s_half, _ = O.optimize(start, camera, CFG, target, steps=2, **kw)
    O.save_state(ck, 2, p_half, s_half)
    params_t = split_params(start, camera)
    step0, p_res, s_res = O.load_state(ck, params_t, O.initial_opt_state(
        "adam", params_t, kw["opt_params"]))
    assert step0 == 2
    p_cont, s_cont, l_cont = O.optimize(
        start, camera, CFG, target, steps=4, init_params=p_res,
        init_opt_state=s_res, start_step=step0, **kw)
    assert l_cont == l_full[2:]
    for k in p_full:
        assert torch.equal(p_full[k], p_cont[k]), k
    for k in s_full:
        for n in s_full[k]:
            assert torch.equal(s_full[k][n], s_cont[k][n]), (k, n)
    # The JAX package reads the same container: its leaves in the order
    # of jax.tree_util.tree_flatten on the same dict.
    _, batch, aux = jx.checkpoint.Checkpointer(ck.path).load()
    assert batch == 2 and len(aux["extra"]) == 3 * 2 + len(p_half)
    np.testing.assert_array_equal(np.asarray(aux["extra"][0]),
                                  s_half["albedo"]["exp_avg"].numpy())


def test_frozen_params_stay_bitwise(box):
    scene, camera, target, start = box
    p0 = split_params(start, camera)
    params, _, _ = O.optimize(start, camera, CFG, target, steps=2, lr=0.1,
                              opt_params=("albedo",), optimizer="sgd",
                              backward="replay")
    for k in p0:
        if k == "albedo":
            assert not torch.equal(params[k], p0[k])
        else:
            assert torch.equal(params[k], p0[k]), k


def test_vertex_optimisation_refits_quad_and_refuses_pallas(monkeypatch):
    scene, cfg = _sphere(300)
    camera = T.OrbitCamera().camera(CPU)
    acc = build_accel(scene, cfg)
    target = 0.9 * T.render_sample(scene, camera, cfg, 0, acc)
    refits = []
    refit = tq.refit_quad
    monkeypatch.setattr(tq, "refit_quad",
                        lambda *a: refits.append(1) or refit(*a))
    params, _, losses = O.optimize(scene, camera, cfg, target, steps=2,
                                   lr=1e-3, opt_params=("vertices",),
                                   accel=acc, advance_seeds=False)
    assert len(refits) == 2 and np.isfinite(losses).all()
    assert not torch.equal(params["vertices"], scene.vertices)

    cfg_w = cfg.replace(traversal="pallas")
    with pytest.raises(ValueError, match="stale baked accel"):
        O.optimize(scene, camera, cfg_w, target, steps=1, lr=1e-3,
                   opt_params=("vertices",), accel=build_accel(scene, cfg_w))


@pytest.mark.parametrize("kw,match", [
    (dict(micro_steps=0), "micro_steps"),
    (dict(steps=1, start_step=2), "start_step"),
    (dict(opt_params=("nope",)), "unknown opt params"),
    (dict(optimizer="lbfgs"), "unknown optimizer"),
])
def test_bad_arguments_raise(box, kw, match):
    scene, camera, target, start = box
    with pytest.raises(ValueError, match=match):
        O.optimize(start, camera, CFG, target, **{"steps": 1, **kw})


def test_cli_optimize_cpu_end_to_end(tmp_path, capsys):
    tgt = str(tmp_path / "target.npy")
    metrics = tmp_path / "m.jsonl"
    common = ["--device", "cpu", "--width", "8", "--height", "8", "--spp",
              "1", "--bounces", "2", "--no-sss", "--metrics", str(metrics)]
    cli.main(["render", *common, "--batches", "1", "--out", tgt])
    assert np.load(tgt).shape == (8, 8, 3)
    opt = ["optimize", *common, "--target", tgt, "--lr", "0.05",
           "--opt-params", "albedo", "--fixed-seeds", "--init-albedo", "0.4",
           "0.4", "0.4"]
    full, losses = cli.main([*opt, "--steps", "3", "--out",
                             str(tmp_path / "full.npz")])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    saved = np.load(tmp_path / "full.npz")
    np.testing.assert_array_equal(saved["albedo"], full["albedo"].numpy())
    true = T.cornell_box_scene(device=CPU).materials.albedo.numpy()
    assert (np.abs(saved["albedo"] - true).mean()
            < np.abs(0.4 - true).mean())
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    steps = [r for r in rows if r["event"] == "opt_step"]
    assert [r["step"] for r in steps] == [0, 1, 2]
    assert all(r["step_ms"] > 0 and np.isfinite(r["loss"]) for r in steps)

    # 2 steps + checkpoint, then on to 3: the same as 3 straight.
    ck = str(tmp_path / "ck.npz")
    cli.main([*opt, "--steps", "2", "--checkpoint", ck, "--out",
              str(tmp_path / "a.npz")])
    resumed, _ = cli.main([*opt, "--steps", "3", "--checkpoint", ck,
                           "--out", str(tmp_path / "b.npz")])
    assert torch.equal(resumed["albedo"], full["albedo"])
    # A performance knob does not change the checkpoint's key; a setup
    # field does.
    capsys.readouterr()
    cli.main([*opt, "--steps", "3", "--compact-frac", "0", "--checkpoint",
              ck, "--out", str(tmp_path / "c.npz")])
    assert "resuming from step 3" in capsys.readouterr().err
    cli.main([*opt, "--steps", "1", "--lr", "0.01", "--checkpoint", ck,
              "--out", str(tmp_path / "d.npz")])
    assert "starting fresh" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    (["--sharded", "--process-id", "0"], "need --num-processes"),
    (["--coordinator", "h:1"], "need --num-processes"),
    (["--num-processes", "2"], "needs --coordinator"),
])
def test_cli_optimize_unported_options_exit(tmp_path, flag, capsys):
    """The multi-process options are ported; an incomplete set of them
    exits before any step, naming what is missing."""
    flag, message = flag
    tgt = tmp_path / "t.npy"
    np.save(tgt, np.zeros((8, 8, 3), np.float32))
    with pytest.raises(SystemExit) as e:
        cli.main(["optimize", "--device", "cpu", "--width", "8", "--height",
                  "8", "--target", str(tgt), *flag])
    assert e.value.code != 0
    assert message in capsys.readouterr().err


def test_params_converter_round_trip(box):
    scene, camera, _, _ = box
    p = split_params(scene, camera)
    back = convert.params_from_arrays({k: v.numpy() for k, v in p.items()},
                                      device=CPU)
    for k in p:
        assert torch.equal(back[k], p[k]), k
