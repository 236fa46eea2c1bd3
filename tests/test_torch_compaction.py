"""The static-capacity carry compaction (render/integrator.py) ≡ dpt_tpu.

The box at 16² (R = 256 lanes), brute search, 2 bounces, with a seeded
albedo and target, through the port and the JAX package at three
capacities: C = 128 with 49 live lanes (chunk 0 live, chunk 1 dead), C =
128 with 256 live lanes (an overflow into a second live chunk), and C = 256
>= R (no compaction).

  - Images are allclose to JAX `render_sample` at rtol 1e-3 / atol 2e-3
    (tests/test_oracle_match.py), and equal the port's uncompacted render
    bit for bit (every lane is independent, the RNG rides the gather).
  - Tape gradients are allclose to JAX `tape_loss_and_grads` of the same
    framing at C = 128: loss at rtol 1e-5, each gradient at rtol 1e-3 with
    atol 1e-4 x max|g| of its key (tests/test_torch_grads.py's tolerance).
  - Record and play run the same chunks; a tape with another number of
    chunks is refused; the live-lane count is read only after chunk 0 is
    queued; a last chunk with pad entries (12², C = 128 of 144 lanes) is
    exact.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.diff import grads as G
from dpt_tpu_torch.render import integrator, renderer

torch.set_num_threads(2)
CPU = "cpu"
RTOL, ATOL = 1e-3, 2e-3
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4
SEED = 3
BASE = dict(width=16, height=16, max_depth=2, spp=1, traversal="brute",
            enable_sss=False, remat_bounces=False)
# case -> (compact_frac, camera radius, live lanes, chunks run)
CASES = {
    "one_live_one_dead": (0.5, 5.0, 49, 1),
    "two_live": (0.5, 2.5, 256, 2),
    "no_compaction": (1.0, 5.0, 49, 0),
}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import dpt_tpu
    from dpt_tpu.diff import grads
    from dpt_tpu.render import renderer as jrenderer

    return types.SimpleNamespace(jnp=jnp, pkg=dpt_tpu, grads=grads,
                                 renderer=jrenderer)


def _arrays():
    rng = np.random.default_rng(7)
    albedo = rng.uniform(0.3, 0.9, (1, 3)).astype(np.float32)
    target = rng.uniform(0.0, 0.5, (16, 16, 3)).astype(np.float32)
    return albedo, target


def _port(case):
    frac, radius, _, _ = CASES[case]
    albedo, target = _arrays()
    scene = T.cornell_box_scene(device=CPU)
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo=torch.as_tensor(albedo)))
    return (scene, T.OrbitCamera(radius=radius).camera(CPU),
            T.RenderConfig(**BASE, compact_frac=frac),
            torch.as_tensor(target))


def _jax(jx, case):
    frac, radius, _, _ = CASES[case]
    albedo, target = _arrays()
    scene = jx.pkg.cornell_box_scene()
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo=jx.jnp.asarray(albedo)))
    return (scene, jx.pkg.OrbitCamera(radius=radius).camera(),
            jx.pkg.RenderConfig(**BASE, compact_frac=frac),
            jx.jnp.asarray(target))


def _chunks_run(tape):
    return len(tape["chunks"]) if "chunks" in tape else 0


def test_capacity_is_jax_rule():
    # ceil(R * frac / 128) * 128; compaction only when 0 < C < R.
    assert integrator.capacity(256, 0.5) == 128
    assert integrator.capacity(256, 0.25) == 128
    assert integrator.capacity(256, 1.0) == 256
    assert integrator.capacity(256, 0.0) == 0
    assert integrator.capacity(1 << 20, 0.125) == 131072
    assert integrator.capacity(1 << 20, 0.0625) == 65536
    assert integrator.capacity(144, 0.125) == 128


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_matches_jax(jx, case):
    scene, cam, cfg, _ = _port(case)
    _, _, live, chunks = CASES[case]
    img, (tape,) = renderer.render_sample_taped(scene, cam, cfg, SEED)
    assert int((tape["prim"]["tri1"] >= 0).sum()) == live
    assert _chunks_run(tape) == chunks
    off = T.render_sample(scene, cam, cfg.replace(compact_frac=0.0), SEED)
    assert torch.equal(img, off)
    js, jc, jcfg, _ = _jax(jx, case)
    ref = jx.renderer.render_sample(js, jc, jcfg, jx.jnp.uint32(SEED))
    assert float(img.max()) > 0.0
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def jax_tape_refs(jx):
    """JAX `tape_loss_and_grads` of each camera, at C = 128 (one program
    for both cameras).  JAX's capacity does not change its estimate (every
    lane is exact at any capacity), so the port's C >= R case is held to
    the same reference."""
    refs = {}
    for case in ("one_live_one_dead", "two_live"):
        js, jc, jcfg, jtarget = _jax(jx, case)
        refs[CASES[case][1]] = jx.grads.tape_loss_and_grads(
            js, jc, jcfg, jtarget, sample_batch=SEED)
    return refs


@pytest.mark.parametrize("case", sorted(CASES))
def test_tape_grads_match_jax(jax_tape_refs, case):
    scene, cam, cfg, target = _port(case)
    loss, grads = G.tape_loss_and_grads(scene, cam, cfg, target,
                                        sample_batch=SEED)
    jl, jg = jax_tape_refs[CASES[case][1]]
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    for k in G.PARAM_KEYS:
        r = np.asarray(jg[k])
        g = grads[k].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), k
        scale = max(float(np.abs(r).max()), 1e-12)
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * scale, err_msg=k)
    assert float(grads["albedo"].abs().max()) > 0.0


def test_record_and_play_take_the_same_chunks(monkeypatch):
    scene, cam, cfg, _ = _port("two_live")
    runs = []
    run_bounces = integrator._run_bounces

    def spy(body, carry, *a):
        runs.append(carry[0].shape[0])
        return run_bounces(body, carry, *a)

    monkeypatch.setattr(integrator, "_run_bounces", spy)
    img, tapes = renderer.render_sample_taped(scene, cam, cfg, SEED)
    recorded = list(runs)
    runs.clear()
    played = renderer.render_sample_playback(scene, cam, cfg, SEED, tapes)
    assert recorded == runs == [128, 128]
    assert torch.equal(played, img)
    tapes[0]["chunks"].append(tapes[0]["chunks"][0])
    with pytest.raises(ValueError, match="3 chunks, its primary selects 2"):
        renderer.render_sample_playback(scene, cam, cfg, SEED, tapes)
    tapes[0]["chunks"][1:] = []
    with pytest.raises(ValueError, match="1 chunks, its primary selects mo"):
        renderer.render_sample_playback(scene, cam, cfg, SEED, tapes)


def test_count_is_read_after_chunk_zero_is_queued(monkeypatch):
    scene, cam, cfg, _ = _port("two_live")
    events = []
    run_bounces = integrator._run_bounces
    value = integrator._HostCount.value

    def spy_run(*a):
        events.append("chunk")
        return run_bounces(*a)

    def spy_value(self):
        events.append("read")
        return value(self)

    monkeypatch.setattr(integrator, "_run_bounces", spy_run)
    monkeypatch.setattr(integrator._HostCount, "value", spy_value)
    T.render_sample(scene, cam, cfg, SEED)
    assert events == ["chunk", "read", "chunk"]


def test_padded_last_chunk_is_exact():
    scene, cam, cfg, _ = _port("two_live")
    cfg = cfg.replace(width=12, height=12, compact_frac=0.125)
    assert integrator.capacity(cfg.n_pixels, cfg.compact_frac) == 128
    img, (tape,) = renderer.render_sample_taped(scene, cam, cfg, SEED)
    assert _chunks_run(tape) == 2  # 144 live lanes: 128 + 16, 112 pads
    for entries in tape["chunks"][1]:
        for e in entries:
            assert e.shape == (128,)
    off = T.render_sample(scene, cam, cfg.replace(compact_frac=0.0), SEED)
    assert torch.equal(img, off)
    assert torch.equal(
        renderer.render_sample_playback(scene, cam, cfg, SEED, [tape]), img)
