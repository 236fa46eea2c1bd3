"""The box-scale path's drivers ≡ dpt_tpu: the pipelined `render_progressive`
(camera reset, checkpoints), the live-fraction diagnostics, the CLI's
`render --checkpoint` / `--compact-frac auto` / `--scene`, `interactive`,
`info`, and the OBJ loader.

  - `render_progressive` through a camera source that moves after two
    batches: the image is allclose to JAX's at rtol 1e-3 / atol 2e-3 (the
    tolerance of tests/test_oracle_match.py), and both publish the same
    batches in the same order.
  - The pipelined loop equals the serial `render` bit for bit, a resume
    from a checkpoint equals the uninterrupted run bit for bit, and a
    camera change restarts the accumulation.
  - `live_fraction_by_depth` and `auto_compact_frac` equal JAX's exactly
    (fractions of whole lane counts, float32 on both sides).
  - The CLI resumes a matching checkpoint (also across a performance flag)
    and resets on a moved camera; an `interactive` session prints JAX's
    lines and saves images allclose to JAX's (the image tolerance above).
  - `load_obj` returns JAX's arrays exactly.
"""

import io
import json
import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch import cli
from dpt_tpu_torch.render import renderer as R
from dpt_tpu_torch.scene.obj import load_obj, write_obj
from dpt_tpu_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(2)
CPU = "cpu"
RTOL, ATOL = 1e-3, 2e-3
# The config `interactive --width 16 --height 16 --bounces 1 --no-sss`
# builds, so both JAX tests below share one compiled render_sample.
CFG = dict(width=16, height=16, max_depth=1, spp=1, traversal="brute",
           enable_sss=False, bvh_builder="median", bvh_leaf_size=4,
           ray_sort=False)
SMALL = T.RenderConfig(width=8, height=8, max_depth=2, spp=1,
                       enable_sss=False, remat_bounces=False,
                       kernels="intersect")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import dpt_tpu
    from dpt_tpu import cli as jcli
    from dpt_tpu.render import renderer
    from dpt_tpu.scene import builder, obj

    return types.SimpleNamespace(pkg=dpt_tpu, renderer=renderer, cli=jcli,
                                 builder=builder, obj=obj)


def _moving_source(pkg, device=None):
    """A camera source that moves after its second call."""
    calls = []

    def source():
        oc = pkg.OrbitCamera()
        if len(calls) >= 2:
            oc = oc.view_update(40.0, 0.0)
        calls.append(oc.state_tuple())
        cam = oc.camera(device) if device else oc.camera()
        return oc.state_tuple(), cam
    return source


def test_render_progressive_matches_jax(jx, box_scene):
    seen = {"jax": [], "port": []}
    jimg, jn = jx.renderer.render_progressive(
        box_scene, _moving_source(jx.pkg), jx.pkg.RenderConfig(**CFG),
        n_batches=3, on_batch=lambda b, im, m: seen["jax"].append(b))
    img, n = T.render_progressive(
        T.cornell_box_scene(device=CPU), _moving_source(T, CPU),
        T.RenderConfig(**CFG, kernels="intersect"), n_batches=3,
        on_batch=lambda b, im, m: seen["port"].append(b))
    assert n == jn == 3
    assert seen["port"] == seen["jax"] == [0, 1, 0, 1, 2]
    assert float(img.max()) > 0.0
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=RTOL,
                               atol=ATOL)


def _box_and_camera():
    return T.cornell_box_scene(device=CPU), T.OrbitCamera(yaw=25.0).camera(
        CPU)


def test_pipelined_equals_serial_and_resume_is_bitwise(tmp_path):
    scene, cam = _box_and_camera()
    serial = T.render(scene, cam, SMALL, n_batches=4)
    metrics = []
    full, n = T.render_progressive(
        scene, cam, SMALL, n_batches=4,
        on_batch=lambda b, im, m: metrics.append((b, m)))
    assert n == 4 and torch.equal(full, serial)
    assert [b for b, _ in metrics] == [0, 1, 2, 3]
    for _, m in metrics:
        assert m["batch_ms"] > 0 and m["rays_per_s"] > 0
        assert set(m) == {"batch_ms", "rays_per_s", "batches_done"}

    ck = Checkpointer(str(tmp_path / "ck.npz"))
    meta = {"camera_state": np.zeros(4), "config_key": "k"}
    half, _ = T.render_progressive(scene, cam, SMALL, n_batches=2,
                                   checkpointer=ck, checkpoint_every=2,
                                   checkpoint_meta=meta)
    img0, batch0, aux = ck.load()
    assert batch0 == 2 and str(aux["meta"]["config_key"]) == "k"
    np.testing.assert_array_equal(img0, half.numpy())
    resumed, n = T.render_progressive(scene, cam, SMALL, n_batches=4,
                                      start_batch=batch0, start_image=img0)
    assert n == 4 and torch.equal(resumed, full)


def test_camera_change_resets_the_accumulation():
    scene = T.cornell_box_scene(device=CPU)
    seen = []
    img, n = T.render_progressive(
        scene, _moving_source(T, CPU), SMALL, n_batches=3,
        on_batch=lambda b, im, m: seen.append(b))
    assert n == 3 and seen == [0, 1, 0, 1, 2]
    fresh = T.render(scene, T.OrbitCamera().view_update(40.0, 0.0).camera(
        CPU), SMALL, n_batches=3)
    assert torch.equal(img, fresh)


def test_live_fraction_by_depth_matches_jax(jx, box_scene, moved_camera):
    over = dict(width=8, height=8, max_depth=3, enable_sss=False,
                russian_roulette=True, rr_start_depth=1)
    ref = jx.renderer.live_fraction_by_depth(
        box_scene, moved_camera, jx.pkg.RenderConfig(**over))
    got = R.live_fraction_by_depth(
        T.cornell_box_scene(device=CPU),
        T.OrbitCamera().view_update(120.0, -60.0).zoom_update(0.9).camera(
            CPU), T.RenderConfig(**over, kernels="intersect"))
    assert len(got) == 3 and got[0] == 1.0 and 0.0 < got[1] < 1.0
    assert got == ref
    assert R.live_fraction_by_depth(None, None, SMALL.replace(
        max_depth=1)) == [1.0]


def test_auto_compact_frac_matches_jax(jx, box_scene, moved_camera):
    """A 32x16 frame probed at 16x8 (the aspect ratio kept)."""
    over = dict(width=32, height=16, max_depth=1, enable_sss=False)
    ref = jx.renderer.auto_compact_frac(
        box_scene, moved_camera, jx.pkg.RenderConfig(**over), probe_side=16)
    got = R.auto_compact_frac(
        T.cornell_box_scene(device=CPU),
        T.OrbitCamera().view_update(120.0, -60.0).zoom_update(0.9).camera(
            CPU), T.RenderConfig(**over), probe_side=16)
    assert 0.0 < got < 1.0 and got == ref


def _render_args(tmp_path, *extra):
    return ["render", "--device", CPU, "--width", "8", "--height", "8",
            "--spp", "1", "--bounces", "1", "--no-sss", "--metrics",
            str(tmp_path / "m.jsonl"), *extra]


def test_cli_render_checkpoint_resume_and_reset(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")

    def run(name, *extra):
        out = str(tmp_path / f"{name}.npy")
        cli.main(_render_args(tmp_path, "--out", out, *extra))
        return np.load(out), capsys.readouterr().err

    run("a", "--checkpoint", ck, "--batches", "2")
    b, err = run("b", "--checkpoint", ck, "--batches", "4")
    assert "resuming from batch 2" in err
    fresh4, _ = run("fresh4", "--batches", "4")
    np.testing.assert_array_equal(b, fresh4)
    # A performance flag keeps the checkpoint's key: the resume goes on.
    _, err = run("c", "--checkpoint", ck, "--batches", "5", "--sort",
                 "--checkpoint-every", "1")
    assert "resuming from batch 4" in err
    # A moved camera resets the accumulation.
    moved, err = run("d", "--checkpoint", ck, "--batches", "2", "--yaw",
                     "35")
    assert "checkpoint framing mismatch" in err and "resuming" not in err
    fresh_moved, _ = run("e", "--batches", "2", "--yaw", "35")
    np.testing.assert_array_equal(moved, fresh_moved)


def test_cli_scene_and_auto_compact(tmp_path, capsys):
    """An OBJ of the box renders the box bit for bit; --compact-frac auto
    prints the fraction it derived."""
    from dpt_tpu_torch.scene import procedural

    obj = str(tmp_path / "box.obj")
    write_obj(obj, *procedural.box_mesh())
    a = cli.main(_render_args(tmp_path, "--scene", obj, "--batches", "1",
                              "--out", str(tmp_path / "a.npy")))
    b = cli.main(_render_args(tmp_path, "--batches", "1", "--compact-frac",
                              "auto", "--out", str(tmp_path / "b.png")))
    assert "auto compact_frac = " in capsys.readouterr().err
    assert torch.equal(a, b)


def test_interactive_session_matches_jax(jx, tmp_path, monkeypatch):
    script = ("render 2\nsave a.npy\norbit 40 -20\nstatus\nrender 2\n"
              "save b.npy\nzoom 0.9\nfov 50\nstatus\nbogus 1\nrender 1\n"
              "save c.npy\nquit\nrender 1\n")
    size = ["--width", "16", "--height", "16", "--bounces", "1", "--no-sss",
            "--out-dir", "."]
    outs = {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        out = io.StringIO()
        if name == "jax":
            args = jx.cli._build_parser().parse_args(["interactive", *size])
            jx.cli.cmd_interactive(args, stdin=io.StringIO(script),
                                   stdout=out)
        else:
            parser = cli._build_parser()
            args = parser.parse_args(["interactive", "--device", CPU, *size])
            cli.cmd_interactive(args, parser, stdin=io.StringIO(script),
                                stdout=out)
        outs[name] = out.getvalue().splitlines()
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == "rendered to batch 2"
    assert outs["port"][2].startswith("batches=0 ")
    for f in ("a.npy", "b.npy", "c.npy"):
        got = np.load(tmp_path / "port" / f)
        assert got.shape == (16, 16, 3)
        np.testing.assert_allclose(got, np.load(tmp_path / "jax" / f),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("argv, size", [
    (["--preset", "box512"], (512, 512)),
    (["--preset", "box512", "--width", "64"], (64, 512)),
    ([], (256, 256)),
    (["--height", "32"], (256, 32)),
])
def test_interactive_keeps_the_preset_resolution(argv, size):
    args = cli._build_parser().parse_args(["interactive", *argv])
    cfg = cli._interactive_cfg(args)
    assert (cfg.width, cfg.height) == size
    assert (cfg.spp, cfg.max_depth) == (1, 2)


def test_info_prints_the_devices(capsys):
    info = cli.main(["info"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == info
    assert printed["torch_version"] == torch.__version__
    assert printed["cuda_available"] == torch.cuda.is_available()
    assert len(printed["devices"]) == torch.cuda.device_count()


OBJ = """# quads, negative indices, texcoords and materials
mtllib m.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0.5
vn 0 0 1
usemtl red
f 1/1 2/2 3/3 4/4
usemtl plain
f -5/-4/1 -4/-3/1 -1/-1/1
o skipped
s off
usemtl red
f 1 4 5
"""
MTL = "newmtl red\nKd 0.9 0.1 0.1\nnewmtl other\nKd 0 0 1\n"


def test_load_obj_matches_jax(jx, tmp_path):
    path = tmp_path / "m.obj"
    path.write_text(OBJ)
    (tmp_path / "m.mtl").write_text(MTL)
    got = load_obj(str(path))
    ref = jx.obj.load_obj(str(path), use_native=False)
    assert got.material_names == ref.material_names == ["red", "plain"]
    for f in ("vertices", "indices", "uvs", "mat_idx", "material_albedo"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.indices.shape == (4, 3)
    scene = T.load_scene(str(path), device=CPU)
    jscene = jx.builder.load_scene(str(path))
    for f in ("vertices", "indices", "uvs", "mat_idx"):
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(jscene, f)))
    np.testing.assert_array_equal(scene.materials.albedo.numpy(),
                                  np.asarray(jscene.materials.albedo))
