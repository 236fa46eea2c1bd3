"""dpt_tpu_torch render operations ≡ dpt_tpu, op by op.

RNG, Morton keys and sort permutations are bit-exact.  The floating-point
ops (sampling, raygen, Möller–Trumbore, reintersect, Oren–Nayar) are
allclose at rtol 1e-5 / atol 1e-6: XLA's and torch's transcendentals, and
their fused dot products, may differ in the last bits.  Inputs are made
with numpy from a fixed seed and fed to both packages.
"""

import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.render import compaction as tc
from dpt_tpu_torch.render import intersect as ti
from dpt_tpu_torch.render import raygen as tr
from dpt_tpu_torch.render import rng as trng
from dpt_tpu_torch.render import sampling as ts
from dpt_tpu_torch.render import shading as tsh

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import dpt_tpu
    from dpt_tpu.render import compaction, intersect, raygen, rng, sampling
    from dpt_tpu.render import shading

    return types.SimpleNamespace(
        jnp=jnp, pkg=dpt_tpu, compaction=compaction, intersect=intersect,
        raygen=raygen, rng=rng, sampling=sampling, shading=shading)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _states(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**32, n, dtype=np.uint64)
    # The top of the range, where every step wraps.
    s[:8] = np.arange(2**32 - 8, 2**32, dtype=np.uint64)
    s[8:12] = [0, 1, 2**31, 2**31 - 1]
    return s.astype(np.uint32)


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_rng_next_bit_exact(jx):
    s = _states()
    js = jx.jnp.asarray(s)
    ts_ = torch.as_tensor(s.astype(np.int64))
    for _ in range(6):
        js, ju = jx.rng.rng_next(js)
        ts_, tu = trng.rng_next(ts_)
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                      ts_.numpy())
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
        assert tu.dtype == torch.float32


@pytest.mark.parametrize("sample_batch", [0, 7, 2**32 - 1, 123_456_789])
def test_seed_pixels_bit_exact(jx, sample_batch):
    w, h = 1031, 517
    py, px = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    j = jx.rng.seed_pixels(sample_batch, jx.jnp.asarray(px, jx.jnp.uint32),
                           jx.jnp.asarray(py, jx.jnp.uint32), w, h)
    t = trng.seed_pixels(sample_batch, torch.as_tensor(px),
                         torch.as_tensor(py), w, h)
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


def _points_and_dirs(n=2048, seed=3):
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    # Exact zeros and signed zeros in the direction components: the octant
    # bit treats -0.0 as >= 0.
    d[:64, 0] = 0.0
    d[64:128, 1] = -0.0
    d[128:130] = [[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0]]
    bmin = np.array([-1.2, -1.1, -1.3], np.float32)
    bmax = np.array([1.3, 1.0, 1.2], np.float32)
    return p, d, bmin, bmax


def test_morton_and_sort_key_exact(jx):
    p, d, bmin, bmax = _points_and_dirs()
    active = np.random.default_rng(4).random(p.shape[0]) < 0.8
    jm = jx.compaction.morton3d(jx.jnp.asarray(p), jx.jnp.asarray(bmin),
                                jx.jnp.asarray(bmax))
    tm = tc.morton3d(_t(p), _t(bmin), _t(bmax))
    np.testing.assert_array_equal(np.asarray(jm).astype(np.int64),
                                  tm.numpy())
    for octant_major in (True, False):
        jk = jx.compaction.ray_sort_key(
            jx.jnp.asarray(p), jx.jnp.asarray(d), jx.jnp.asarray(active),
            jx.jnp.asarray(bmin), jx.jnp.asarray(bmax), octant_major)
        tk = tc.ray_sort_key(_t(p), _t(d), _t(active), _t(bmin), _t(bmax),
                             octant_major)
        np.testing.assert_array_equal(np.asarray(jk).astype(np.int64),
                                      tk.numpy())
    # The x-sign bit (4 << 30) wraps away in uint32: +x rays share keys
    # with their -x mirror octant.
    assert int(tk.max()) <= 0xFFFFFFFF
    tk = tc.ray_sort_key(_t(p), _t(d), _t(np.ones_like(active)), _t(bmin),
                         _t(bmax))
    assert int(tk[128]) >> 30 == 3 and int(tk[129]) >> 30 == 0


def test_sort_permutation_equal(jx):
    p, d, bmin, bmax = _points_and_dirs(seed=5)
    # Many ties: coarse points and a block of inactive rays.
    p = np.round(p, 1).astype(np.float32)
    active = np.ones(p.shape[0], bool)
    active[::3] = False
    jp = jx.compaction.sort_permutation(
        jx.jnp.asarray(p), jx.jnp.asarray(d), jx.jnp.asarray(active),
        jx.jnp.asarray(bmin), jx.jnp.asarray(bmax))
    tp = tc.sort_permutation(_t(p), _t(d), _t(active), _t(bmin), _t(bmax))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    a = torch.arange(p.shape[0], dtype=torch.float32)
    (back,) = tc.scatter_back(tp, a[tp])
    assert torch.equal(back, a)


def test_sampling_matches(jx):
    s = _states(2048, seed=1)
    js, ts_ = jx.jnp.asarray(s), torch.as_tensor(s.astype(np.int64))
    n = _dirs(2048, 2)
    n[:16] = [0.0, 0.0, 1.0]  # the |n.z| >= 0.999 branch
    _, jg = jx.sampling.random_gaussian(js)
    _, tg = ts.random_gaussian(ts_)
    _close(jg, tg)
    _, jh = jx.sampling.sample_hemisphere(jx.jnp.asarray(n), js)
    _, th = ts.sample_hemisphere(_t(n), ts_)
    _close(jh, th)
    _, jsp = jx.sampling.sample_sphere(js)
    _, tsp = ts.sample_sphere(ts_)
    _close(jsp, tsp)

    lp = np.array([0.3, 2.0, -0.1], np.float32)
    ln = np.array([0.0, -1.0, 0.0], np.float32)
    lsz = np.array([2.5, 1.5], np.float32)
    _, jl = jx.sampling.sample_area_light(jx.jnp.asarray(lp),
                                          jx.jnp.asarray(ln),
                                          jx.jnp.asarray(lsz), js)
    _, tl = ts.sample_area_light(_t(lp), _t(ln), _t(lsz), ts_)
    _close(jl, tl)

    o = (np.random.default_rng(3).normal(size=(2048, 3))).astype(np.float32)
    d = _dirs(2048, 4)
    jh2, jt2 = jx.sampling.intersect_area_light(
        jx.jnp.asarray(o), jx.jnp.asarray(d), jx.jnp.asarray(lp),
        jx.jnp.asarray(ln), jx.jnp.asarray(lsz))
    th2, tt2 = ts.intersect_area_light(_t(o), _t(d), _t(lp), _t(ln), _t(lsz))
    np.testing.assert_array_equal(np.asarray(jh2), th2.numpy())
    assert th2.any()
    _close(np.where(np.asarray(jh2), np.asarray(jt2), 0.0),
           torch.where(th2, tt2, 0.0))


@pytest.mark.parametrize("dof", [True, False])
@pytest.mark.parametrize("moved", [False, True])
def test_generate_rays_matches(jx, dof, moved):
    jo, to = jx.pkg.OrbitCamera(), T.OrbitCamera()
    if moved:
        jo, to = (c.view_update(120.0, -60.0).zoom_update(0.9)
                  for c in (jo, to))
    jcfg = jx.pkg.RenderConfig(width=24, height=16, enable_dof=dof)
    tcfg = T.RenderConfig(width=24, height=16, enable_dof=dof)
    jo_, jd_, js_ = jx.raygen.generate_rays(jo.camera(), jcfg, 5)
    to_, td_, ts__ = tr.generate_rays(to.camera("cpu"), tcfg, 5)
    np.testing.assert_array_equal(np.asarray(js_).astype(np.int64),
                                  ts__.numpy())
    _close(jo_, to_)
    _close(jd_, td_)


def _tris(n_rays=512, n_tris=64, seed=7):
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    v1 = (v0 + rng.normal(size=(n_tris, 3)) * 0.7).astype(np.float32)
    v2 = (v0 + rng.normal(size=(n_tris, 3)) * 0.7).astype(np.float32)
    o = (rng.normal(size=(n_rays, 3)) * 3.0).astype(np.float32)
    d = _dirs(n_rays, seed + 1)
    return o, d, v0, v1, v2


def test_moller_trumbore_matches(jx):
    o, d, v0, v1, v2 = _tris()
    j = jx.intersect.moller_trumbore(
        jx.jnp.asarray(o)[:, None], jx.jnp.asarray(d)[:, None],
        jx.jnp.asarray(v0)[None], jx.jnp.asarray(v1)[None],
        jx.jnp.asarray(v2)[None])
    t = ti.moller_trumbore(_t(o)[:, None], _t(d)[:, None], _t(v0)[None],
                           _t(v1)[None], _t(v2)[None])
    np.testing.assert_array_equal(np.asarray(j[0]), t[0].numpy())
    assert t[0].any()
    hit = t[0].numpy()
    for a, b in zip(j[1:], t[1:]):
        _close(np.asarray(a)[hit], b.numpy()[hit], rtol=RTOL, atol=ATOL)

    jb = jx.intersect.brute_force_nearest(*(jx.jnp.asarray(x) for x in
                                            (o, d, v0, v1, v2)))
    tb = ti.brute_force_nearest(*(_t(x) for x in (o, d, v0, v1, v2)))
    np.testing.assert_array_equal(np.asarray(jb[0]), tb[0].numpy())
    np.testing.assert_array_equal(np.asarray(jb[2]), tb[2].numpy())
    _close(np.asarray(jb[1]), tb[1].numpy())
    md = np.full(o.shape[0], 3.0, np.float32)
    np.testing.assert_array_equal(
        np.asarray(jx.intersect.brute_force_occluded(
            *(jx.jnp.asarray(x) for x in (o, d, md, v0, v1, v2)))),
        ti.brute_force_occluded(*(_t(x) for x in (o, d, md, v0, v1,
                                                  v2))).numpy())


def test_reintersect_matches(jx):
    scene_j = jx.pkg.procedural_scene(n_tris_target=500)
    scene_t = T.procedural_scene(n_tris_target=500, device="cpu")
    rng = np.random.default_rng(11)
    n = 1024
    tri = rng.integers(0, scene_t.n_triangles, n).astype(np.int32)
    # Rays aimed near each selected triangle, from 0.5-3 units away.
    v = scene_t.vertices.numpy()[scene_t.indices.numpy()[tri]]  # [n, 3, 3]
    w = rng.dirichlet([1.0, 1.0, 1.0], n).astype(np.float32)
    target = (w[:, :, None] * v).sum(axis=1)
    d = _dirs(n, 12)
    o = (target - d * rng.uniform(0.5, 3.0, (n, 1))).astype(np.float32)
    uvs = rng.random(size=(scene_t.n_triangles, 3, 2)).astype(np.float32)
    j = jx.intersect.reintersect(
        jx.jnp.asarray(o), jx.jnp.asarray(d), jx.jnp.asarray(tri),
        scene_j.vertices, scene_j.indices, 1e-6, uvs=jx.jnp.asarray(uvs))
    t = ti.reintersect(_t(o), _t(d), _t(tri), scene_t.vertices,
                       scene_t.indices, 1e-6, uvs=_t(uvs))
    for k in ("t", "u", "v", "position", "normal", "uv"):
        _close(np.asarray(j[k]), t[k].numpy())


def test_shading_matches(jx):
    rng = np.random.default_rng(13)
    n_, l_, v_ = _dirs(1024, 14), _dirs(1024, 15), _dirs(1024, 16)
    sigma = rng.random(1024).astype(np.float32)
    sigma[:32] = 0.0
    j = jx.shading.oren_nayar_factor(*(jx.jnp.asarray(x) for x in
                                       (n_, l_, v_, sigma)))
    t = tsh.oren_nayar_factor(*(_t(x) for x in (n_, l_, v_, sigma)))
    _close(j, t)
    assert torch.all(t[:32] == 1.0)
    albedo = rng.random((1024, 3)).astype(np.float32)
    uv = (rng.random((1024, 2)) * 2.0 - 0.5).astype(np.float32)
    _close(jx.shading.checker_albedo(jx.jnp.asarray(albedo),
                                     jx.jnp.asarray(uv), 8.0),
           tsh.checker_albedo(_t(albedo), _t(uv), 8.0))
    corners = rng.random((1024, 3, 2)).astype(np.float32)
    uu, vv = rng.random(1024).astype(np.float32), rng.random(1024).astype(
        np.float32)
    _close(jx.shading.interpolate_uv(jx.jnp.asarray(corners),
                                     jx.jnp.asarray(uu), jx.jnp.asarray(vv)),
           tsh.interpolate_uv(_t(corners), _t(uu), _t(vv)))


def _wavefront_inputs(traversal):
    """(scene, camera, cfg, accel): the box through the per-ray walk (the
    JAX package's tests/test_compaction.py framing) or the sphere through
    the quad walk, with SSS and Russian roulette."""
    from dpt_tpu_torch.accel.bvh import build_accel

    if traversal == "bvh":
        scene = T.cornell_box_scene(device="cpu")
        cfg = T.RenderConfig(width=16, height=16, max_depth=3, spp=1,
                             traversal="bvh", bvh_leaf_size=2,
                             enable_sss=True, russian_roulette=True)
    else:
        scene = T.procedural_scene(n_tris_target=600, device="cpu")
        cfg = T.preset("sylveon512", width=16, height=16, max_depth=3,
                       ray_sort=False, russian_roulette=True,
                       rr_start_depth=1)
    return scene, T.OrbitCamera().camera("cpu"), cfg, build_accel(scene, cfg)


@pytest.mark.parametrize("ray_sort", [False, True])
@pytest.mark.parametrize("traversal", ["bvh", "quad"])
def test_wavefront_render_bit_identical(traversal, ray_sort):
    """The carry-level wavefront sort is a pure permutation of lanes: the
    image is the unsorted render's bit for bit, and with ray_sort too (the
    per-query sort is then off, not applied twice)."""
    scene, cam, cfg, accel = _wavefront_inputs(traversal)
    cfg = cfg.replace(ray_sort=ray_sort)
    ref = T.render_sample(scene, cam, cfg, 0, accel)
    got = T.render_sample(scene, cam, cfg.replace(wavefront_sort=True), 0,
                          accel)
    assert float(ref.max()) > 0.0
    assert torch.equal(got, ref)


@pytest.mark.parametrize("backward", ["plain", "tape"])
def test_wavefront_grads_identical(backward):
    """A permutation's gather and scatter transpose to a collision-free
    scatter and gather: gradients with the wavefront sort equal those
    without (rtol 1e-6, tests/test_compaction.py); the tape records each
    bounce's t, so its playback sorts by the same keys."""
    from dpt_tpu_torch.diff import grads as G

    scene, cam, cfg, accel = _wavefront_inputs("quad")
    cfg = cfg.replace(width=8, height=8)
    fn = (G.render_loss_and_grads if backward == "plain"
          else G.tape_loss_and_grads)
    target = torch.full((8, 8, 3), 0.1)
    loss0, g0 = fn(scene, cam, cfg, target, 0, accel)
    loss1, g1 = fn(scene, cam, cfg.replace(wavefront_sort=True), target, 0,
                   accel)
    assert float(loss0) == float(loss1)
    assert float(g0["albedo"].abs().max()) > 0.0
    for k in G.PARAM_KEYS:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-6,
                                   atol=0.0, err_msg=k)
