"""dpt_tpu_torch gradients: the tape, replay and plain backwards ≡ dpt_tpu.

Inputs (scene, camera, packed BVH) are built by the JAX package, carried
across as numpy arrays with utils/convert.py, and the target image is made
with numpy from a seed, so both packages differentiate the same function.

  - For the brute, quad (K1) and paired-children (K2, `pallas`) traversals,
    the port's tape, replay and plain gradients are allclose to JAX
    `tape_loss_and_grads` with the same traversal: loss at rtol 1e-5, each
    gradient at rtol 1e-3 with atol 1e-4 x max|g| of its key (float32
    renders summed over pixels in another order; the detached hit choices
    are the same).  The brute case is the full-featured one (SSS, Russian
    roulette, 2 spp, compaction, remat); the BVH cases run the coherence
    sort.
  - The taped forward is the plain render bit for bit, the playback equals
    it, and the playback calls no traversal and no coherence sort.
  - Finite differences confirm an albedo and a vertex gradient.
"""

import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.diff import grads as G
from dpt_tpu_torch.kernels import quad as tq
from dpt_tpu_torch.kernels import wide as tw
from dpt_tpu_torch.render import compaction, integrator, renderer
from dpt_tpu_torch.utils import convert

torch.set_num_threads(2)
CPU = "cpu"
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4

BASE = dict(width=8, height=8, max_depth=2, spp=1, enable_sss=False,
            bvh_builder="median", bvh_leaf_size=4, remat_bounces=False)
CASES = {
    "brute": dict(traversal="brute", enable_sss=True, russian_roulette=True,
                  rr_start_depth=1, spp=2, compact_frac=0.25,
                  remat_bounces=True),
    "quad": dict(traversal="quad", ray_sort=True, compact_frac=0.0),
    "pallas": dict(traversal="pallas", ray_sort=True, compact_frac=0.25),
}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import dpt_tpu
    from dpt_tpu.accel.bvh import build_accel
    from dpt_tpu.diff import grads

    return types.SimpleNamespace(jnp=jnp, pkg=dpt_tpu, grads=grads,
                                 build_accel=build_accel)


def _scene_arrays(scene):
    m, lt = scene.materials, scene.lights
    return [np.asarray(x) for x in (
        scene.vertices, scene.indices, scene.uvs, scene.mat_idx,
        m.albedo, m.roughness, m.emission, m.sss_albedo, m.sss_radius,
        lt.position, lt.normal, lt.intensity, lt.size)]


def _camera_arrays(camera):
    return [np.asarray(getattr(camera, f))
            for f in ("position", "direction", "up", "fov_deg")]


def _accel_to_port(accel):
    if accel is None:
        return None
    if hasattr(accel, "n_wide"):
        return convert.quad_accel_from_arrays(
            np.asarray(accel.nodes_flat), np.asarray(accel.tris),
            accel.n_wide, accel.max_depth, device=CPU)
    return convert.wide_accel_from_arrays(
        np.asarray(accel.nodes), np.asarray(accel.tris), accel.n_internal,
        accel.max_depth, device=CPU)


@pytest.fixture(scope="module")
def box(jx):
    """(JAX scene, camera) and their port copies, with a seeded albedo and a
    seeded target."""
    import dataclasses

    rng = np.random.default_rng(7)
    js = jx.pkg.cornell_box_scene()
    js = dataclasses.replace(js, materials=dataclasses.replace(
        js.materials, albedo=jx.jnp.asarray(
            rng.uniform(0.3, 0.9, (1, 3)).astype(np.float32))))
    jc = jx.pkg.OrbitCamera().view_update(120.0, -60.0).zoom_update(
        0.9).camera()
    target = rng.uniform(0.0, 0.5, (8, 8, 3)).astype(np.float32)
    return types.SimpleNamespace(
        js=js, jc=jc, target=target,
        ts=convert.scene_from_arrays(*_scene_arrays(js), device=CPU),
        tc=convert.camera_from_arrays(*_camera_arrays(jc), device=CPU))


def _assert_grads_close(got, ref, what):
    assert set(got) == set(G.PARAM_KEYS)
    for k in G.PARAM_KEYS:
        r = np.asarray(ref[k])
        g = got[k].numpy()
        assert g.shape == r.shape, (what, k)
        assert np.isfinite(g).all(), (what, k)
        scale = max(float(np.abs(r).max()), 1e-12)
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * scale,
                                   err_msg=f"{what}:{k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_jax_tape(jx, box, case):
    over = {**BASE, **CASES[case]}
    jcfg = jx.pkg.RenderConfig(**over, packet_tile=128, interleave=1)
    cfg = T.RenderConfig(**over)
    jacc = jx.build_accel(box.js, jcfg)
    acc = _accel_to_port(jacc)
    jl, jg = jx.grads.tape_loss_and_grads(
        box.js, box.jc, jcfg, jx.jnp.asarray(box.target), sample_batch=3,
        accel=jacc)
    target = torch.as_tensor(box.target)
    got = {}
    for name, fn in (("tape", G.tape_loss_and_grads),
                     ("replay", G.replay_loss_and_grads),
                     ("plain", G.render_loss_and_grads)):
        loss, grads = fn(box.ts, box.tc, cfg, target, sample_batch=3,
                         accel=acc)
        np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL,
                                   err_msg=name)
        _assert_grads_close(grads, jg, f"{case}/{name}")
        got[name] = (loss, grads)
    # The taped forward is the plain forward.
    assert torch.equal(got["tape"][0], got["plain"][0])
    assert float(got["tape"][1]["vertices"].abs().max()) > 0.0


def _flagship_like(traversal, **over):
    scene = T.procedural_scene(n_tris_target=600, device=CPU)
    cfg = T.preset("sylveon512", width=12, height=12, traversal=traversal,
                   **{"max_depth": 3, **over})
    from dpt_tpu_torch.accel.bvh import build_accel

    return scene, T.OrbitCamera(yaw=15.0).camera(CPU), cfg, build_accel(
        scene, cfg)


@pytest.mark.parametrize("traversal", ["quad", "pallas"])
def test_taped_render_and_playback(traversal, monkeypatch):
    scene, cam, cfg, accel = _flagship_like(traversal, spp=2)
    img = T.render_sample(scene, cam, cfg, 5, accel)
    calls = {"walk": 0, "sort": 0}
    mod = tq if traversal == "quad" else tw
    walk, sort = mod._dispatch, compaction.sort_permutation

    def counted_walk(*a, **k):
        calls["walk"] += 1
        return walk(*a, **k)

    def counted_sort(*a, **k):
        calls["sort"] += 1
        return sort(*a, **k)

    monkeypatch.setattr(mod, "_dispatch", counted_walk)
    monkeypatch.setattr(compaction, "sort_permutation", counted_sort)
    img_t, tapes = renderer.render_sample_taped(scene, cam, cfg, 5, accel)
    assert torch.equal(img, img_t)
    # 2 spp x (primary + depth 3 x (nearest + NEE + 3 x (SSS nearest + NEE)))
    # minus bounce 0's nearest, which reuses the primary.
    assert calls["walk"] == 2 * (1 + 3 * 8 - 1)
    assert calls["sort"] == 2 * (3 * 8 - 1)
    before = dict(calls)
    img_p = renderer.render_sample_playback(scene, cam, cfg, 5, tapes)
    assert calls == before
    assert torch.equal(img_p, img)


def test_playback_rebuilds_the_compaction_from_the_tape(monkeypatch):
    """The playback's n_live and Morton permutation come from the taped
    primary (hit, t), and equal the recording's."""
    scene, cam, cfg, accel = _flagship_like("pallas", max_depth=2)
    seen = []
    live_permutation = integrator._live_permutation

    def spy(prim, *a):
        seen.append((prim, live_permutation(prim, *a)))
        return seen[-1][1]

    monkeypatch.setattr(integrator, "_live_permutation", spy)
    _, tapes = renderer.render_sample_taped(scene, cam, cfg, 1, accel)
    (prim_r, perm_r), = seen
    n_live = int((tapes[0]["prim"]["tri1"] >= 0).sum())
    assert 0 < n_live < cfg.n_pixels and perm_r.shape == (n_live,)
    # Every entry of every bounce holds exactly the n_live compacted lanes.
    for entries in tapes[0]["bounces"]:
        for e in entries:
            assert e.shape == (n_live,)
    seen.clear()
    renderer.render_sample_playback(scene, cam, cfg, 1, tapes)
    (prim_p, perm_p), = seen
    assert torch.equal(prim_p["hit"], prim_r["hit"])
    assert torch.equal(prim_p["t"], prim_r["t"])
    assert torch.equal(perm_p, perm_r)


def test_remat_keeps_values_and_grads():
    scene, cam, cfg, accel = _flagship_like("quad", max_depth=2)
    target = torch.full((12, 12, 3), 0.1)
    res = [fn(scene, cam, cfg.replace(remat_bounces=r), target,
              sample_batch=2, accel=accel)
           for fn in (G.tape_loss_and_grads, G.render_loss_and_grads)
           for r in (True, False)]
    for loss, grads in res[1:]:
        assert torch.equal(loss, res[0][0])
        for k in G.PARAM_KEYS:
            torch.testing.assert_close(grads[k], res[0][1][k], rtol=1e-5,
                                       atol=1e-7, msg=k)


def test_fd_confirms_albedo_and_vertex_grads():
    scene = T.cornell_box_scene(device=CPU)
    cam = T.OrbitCamera().view_update(120.0, -60.0).zoom_update(0.9).camera(
        CPU)
    cfg = T.RenderConfig(**BASE, traversal="brute")
    f, params = G.differentiable_render(scene, cam, cfg)
    # A target one below the image: the loss is then about 1 and its
    # gradient 2/N times that of the image sum, large against float32
    # cancellation in the differences.
    target = f(params) - 1.0
    _, g = G.tape_loss_and_grads(scene, cam, cfg, target)

    def loss_at(key, idx, delta):
        p = {k: v.clone() for k, v in params.items()}
        p[key].view(-1)[idx] += delta
        return float(torch.mean((f(p) - target) ** 2))

    def fd(key, idx, eps):
        return (loss_at(key, idx, eps) - loss_at(key, idx, -eps)) / (2 * eps)

    for idx in range(3):
        a = float(g["albedo"].view(-1)[idx])
        assert abs(a) > 1e-3
        assert abs(a - fd("albedo", idx, 1e-3)) <= 2e-2 * abs(a), idx
    gv = g["vertices"].view(-1)
    checked = 0
    for idx in torch.argsort(-gv.abs())[:6].tolist():
        num = fd("vertices", idx, 2e-4)
        if abs(num) <= 1e-2:
            continue
        checked += 1
        # Detached visibility makes FD only a loose bound: sign and scale.
        assert np.sign(float(gv[idx])) == np.sign(num), (idx, gv[idx], num)
        assert 0.2 < abs(float(gv[idx]) / num) < 5.0, (idx, gv[idx], num)
    assert checked >= 1


def test_params_carry_across(jx, box):
    jp = jx.grads.split_params(box.js, box.jc)
    tp = convert.params_from_arrays({k: np.asarray(v) for k, v in jp.items()},
                                    device=CPU)
    own = G.split_params(box.ts, box.tc)
    assert set(tp) == set(own) == set(G.PARAM_KEYS)
    for k in G.PARAM_KEYS:
        assert torch.equal(tp[k], own[k]), k
    s, c = G.merge_params(tp, box.ts, box.tc)
    assert torch.equal(s.materials.albedo, box.ts.materials.albedo)
    assert torch.equal(c.fov_deg, box.tc.fov_deg)
    with pytest.raises(ValueError):
        convert.params_from_arrays({"albedo": np.zeros(3)}, device=CPU)
