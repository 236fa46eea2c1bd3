"""The ported forward render, end to end, ≡ dpt_tpu.

Images are allclose at rtol 1e-3 / atol 2e-3, the tolerance of
tests/test_oracle_match.py.  The flagship-shaped render is held against
JAX `render_sample` with `traversal="brute"`, the JAX package's plain
reference for its quad kernel (tests/test_pallas_quad.py holds quad ≡ brute),
which avoids interpreting the Pallas kernel for a whole render.
"""

import json
import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch import cli
from dpt_tpu_torch.accel.bvh import build_accel

torch.set_num_threads(2)
RTOL, ATOL = 1e-3, 2e-3


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import dpt_tpu
    from dpt_tpu.render import renderer

    return types.SimpleNamespace(jnp=jnp, pkg=dpt_tpu, renderer=renderer)


def _flagship(width=16, height=16, **over):
    """sylveon512's recipe (quad, SAH leaf 8, ray_sort, SSS, compaction) at
    a small frame, depth 4."""
    return T.preset("sylveon512", width=width, height=height, max_depth=4,
                    **over)


@pytest.fixture(scope="module")
def sphere():
    scene = T.procedural_scene(n_tris_target=2_000, device="cpu")
    cfg = _flagship()
    return scene, cfg, build_accel(scene, cfg)


def test_flagship_render_matches_jax(jx, sphere):
    scene, cfg, accel = sphere
    assert cfg.compact_frac > 0 and cfg.ray_sort and cfg.enable_sss
    img = T.render_sample(scene, T.OrbitCamera().camera("cpu"), cfg, 0, accel)
    jcfg = jx.pkg.preset("sylveon512", width=16, height=16, max_depth=4,
                         traversal="brute")
    ref = jx.renderer.render_sample(
        jx.pkg.procedural_scene(n_tris_target=2_000),
        jx.pkg.OrbitCamera().camera(), jcfg, jx.jnp.uint32(0))
    assert img.shape == (16, 16, 3) and img.dtype == torch.float32
    assert float(img.max()) > 0.0
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_quad_matches_brute(sphere):
    scene, cfg, accel = sphere
    cam = T.OrbitCamera(yaw=30.0).camera("cpu")
    img_q = T.render_sample(scene, cam, cfg, 3, accel)
    img_b = T.render_sample(scene, cam, cfg.replace(traversal="brute"), 3)
    np.testing.assert_allclose(img_q.numpy(), img_b.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_compaction_is_exact_per_lane(sphere):
    scene, cfg, accel = sphere
    cam = T.OrbitCamera().camera("cpu")
    on = T.render_sample(scene, cam, cfg, 1, accel)
    off = T.render_sample(scene, cam, cfg.replace(compact_frac=0.0), 1, accel)
    assert torch.equal(on, off)


FULL_FEATURED = dict(width=12, height=12, max_depth=2, spp=1,
                     traversal="brute", remat_bounces=False)


def _moved(pkg):
    return pkg.OrbitCamera().view_update(120.0, -60.0).zoom_update(0.9)


def test_box_full_featured_matches_jax(jx):
    img = T.render_sample(T.cornell_box_scene(device="cpu"),
                          _moved(T).camera("cpu"),
                          T.RenderConfig(**FULL_FEATURED), 0)
    ref = jx.renderer.render_sample(
        jx.pkg.cornell_box_scene(), _moved(jx.pkg).camera(),
        jx.pkg.RenderConfig(**FULL_FEATURED), jx.jnp.uint32(0))
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_render_two_batches_matches_jax(jx):
    img = T.render(T.cornell_box_scene(device="cpu"),
                   _moved(T).camera("cpu"),
                   T.RenderConfig(**FULL_FEATURED), n_batches=2)
    ref = jx.renderer.render(jx.pkg.cornell_box_scene(),
                             _moved(jx.pkg).camera(),
                             jx.pkg.RenderConfig(**FULL_FEATURED),
                             n_batches=2)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_render_progressive_reports_metrics(sphere):
    scene, cfg, accel = sphere
    seen = []
    img, n = T.render_progressive(
        scene, T.OrbitCamera().camera("cpu"), cfg, accel=accel, n_batches=2,
        on_batch=lambda b, im, m: seen.append((b, m)))
    ref = T.render(scene, T.OrbitCamera().camera("cpu"), cfg, n_batches=2,
                   accel=accel)
    assert n == 2 and torch.equal(img, ref)
    assert [b for b, _ in seen] == [0, 1]
    for _, m in seen:
        assert m["batch_ms"] > 0 and m["rays_per_s"] > 0
        assert set(m) == {"batch_ms", "rays_per_s", "batches_done"}


def test_cli_render_cpu_writes_png(tmp_path):
    out = tmp_path / "r.png"
    metrics = tmp_path / "m.jsonl"
    img = cli.main(["render", "--device", "cpu", "--preset", "sylveon512",
                    "--procedural-tris", "1000", "--width", "16",
                    "--height", "16", "--bounces", "2", "--batches", "2",
                    "--out", str(out), "--metrics", str(metrics)])
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
    assert float(img.max()) > 0.0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [r["batch"] for r in rows] == [0, 1]
    assert all(r["device"] == "cpu" and r["rays_per_s"] > 0 for r in rows)


@pytest.mark.parametrize("flag", [
    (["--num-processes", "2"], "needs --coordinator"),
    (["--sharded", "--num-processes", "2", "--coordinator", "h:1"],
     "needs --coordinator HOST:PORT and --process-id"),
    (["--coordinator", "h:1"], "need --num-processes"),
    (["--num-processes", "2", "--coordinator", "h:1", "--process-id", "2"],
     "not in [0, 2)"),
    (["--process-id", "0"], "need --num-processes"),
])
def test_cli_unported_options_exit(tmp_path, flag, capsys):
    """The multi-process options are ported; an incomplete or inconsistent
    set of them exits before any rendering, naming what is missing."""
    flag, message = flag
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--device", "cpu", "--out",
                  str(tmp_path / "x.png"), *flag])
    assert e.value.code != 0
    assert message in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()


def test_cli_default_device_needs_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--out", str(tmp_path / "x.png")])
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()
