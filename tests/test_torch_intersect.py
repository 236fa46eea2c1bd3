"""K3, the brute-force nearest-hit search (kernels/intersect.py) ≡ dpt_tpu.

  - `pack_tris` is byte-identical to the JAX package's, on the box and on a
    triangle count that is not a multiple of 8, and refuses 2**24
    triangles (an id stored as float32 stops being exact there).
  - The plain K3 run on the JAX package's table equals JAX `pallas_nearest`
    (interpret mode, as tests/test_pallas_intersect.py runs it: 256 rays
    against the box): hit and tri exact, t at rtol 1e-5 / atol 1e-6 where
    a ray hits, 1e30 where it misses.  It equals the port's
    `brute_force_nearest` at the same tolerance, ties go to the lowest
    triangle id, and `eps` decides the t > eps test.
  - `render_sample` with kernels="intersect" is allclose to kernels="none"
    at rtol 1e-4 / atol 1e-5 (the JAX package's tolerance,
    tests/test_pallas_intersect.py:39-40); every nearest query of the
    integrator is one K3 call on a table packed once per render.
  - Tests marked `cuda` hold the kernel to the plain version exactly (hit,
    tri and t) on the card; they skip without one.
"""

import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.kernels import intersect as K
from dpt_tpu_torch.render.intersect import brute_force_nearest
from dpt_tpu_torch.utils import convert

torch.set_num_threads(2)
T_RTOL, T_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from dpt_tpu.kernels import pallas_intersect

    return types.SimpleNamespace(jnp=jnp, k3=pallas_intersect)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(n=256, seed=0):
    """tests/test_pallas_intersect.py's rays: origins around the box, random
    unit directions (a few hit)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 3
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _aimed_rays(v0, v1, v2, n, seed):
    """Rays from outside the scene toward random points of its triangles:
    most of them hit."""
    rng = np.random.default_rng(seed)
    tid = rng.integers(0, v0.shape[0], n)
    a, b = rng.random((2, n, 1)) * 0.5
    p = v0[tid] + a * (v1[tid] - v0[tid]) + b * (v2[tid] - v0[tid])
    o = rng.normal(size=(n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = p - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _corners(scene):
    return tuple(v.numpy() for v in scene.tri_vertices())


def _box_corners():
    return _corners(T.cornell_box_scene(device="cpu"))


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("which", ["box", "13 tris"])
def test_pack_tris_byte_identical(jx, which):
    if which == "box":
        v0, v1, v2 = _box_corners()
    else:
        v0, v1, v2 = np.random.default_rng(4).normal(
            size=(3, 13, 3)).astype(np.float32)
    ref = np.asarray(jx.k3.pack_tris(*(jx.jnp.asarray(v) for v in
                                       (v0, v1, v2))))
    got = K.pack_tris(*_t(v0, v1, v2))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert got.shape == (-(-v0.shape[0] // 8), 128)
    assert got.numpy().tobytes() == ref.tobytes()


def test_pack_tris_refuses_2_24_triangles():
    v = torch.empty((K.MAX_TRIS, 3), device="meta")
    with pytest.raises(ValueError, match="float32"):
        K.pack_tris(v, v, v)


@pytest.fixture(scope="module")
def jax_box_hits(jx):
    """(JAX's box table, rays, and pallas_nearest's hit / t / tri)."""
    v0, v1, v2 = (jx.jnp.asarray(v) for v in _box_corners())
    o, d = _rays()
    hit, t, tri = jx.k3.pallas_nearest(jx.jnp.asarray(o), jx.jnp.asarray(d),
                                       v0, v1, v2)
    table = np.asarray(jx.k3.pack_tris(v0, v1, v2))
    return table, o, d, (np.asarray(hit), np.asarray(t), np.asarray(tri))


def test_plain_matches_jax_pallas_nearest(jax_box_hits):
    table, o, d, (jh, jt, ji) = jax_box_hits
    tris = convert.intersect_table_from_arrays(table, device="cpu")
    h, t, i = K.intersect_nearest_reference(*_t(o, d), tris)
    assert h.any() and not h.all()
    np.testing.assert_array_equal(h.numpy(), jh)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(t.numpy()[jh], jt[jh], rtol=T_RTOL,
                               atol=T_ATOL)
    assert (t.numpy()[~jh] == np.float32(K.T_MAX)).all()
    assert (jt[~jh] == np.float32(K.T_MAX)).all()
    assert (i.numpy()[~jh] == 0).all()


@pytest.mark.parametrize("which", ["box", "sphere"])
def test_plain_matches_brute_force(which):
    if which == "box":
        v = _box_corners()
        o, d = _rays(512, seed=1)
    else:
        v = _corners(T.procedural_scene(n_tris_target=500, device="cpu"))
        o, d = _aimed_rays(*v, 512, seed=2)
    v0, v1, v2 = _t(*v)
    o, d = _t(o, d)
    h, t, i = K.intersect_nearest(o, d, K.pack_tris(v0, v1, v2))
    bh, bt, bi, _, _ = brute_force_nearest(o, d, v0, v1, v2)
    assert int(h.sum()) >= 16
    assert torch.equal(h, bh) and torch.equal(i, bi)
    np.testing.assert_allclose(t[h].numpy(), bt[h].numpy(), rtol=T_RTOL,
                               atol=T_ATOL)


def test_ties_go_to_lowest_id():
    """A triangle and its copy, in different rows of the table: every ray
    that hits them reports the lower id, as brute_force_nearest does."""
    v0, v1, v2 = _box_corners()
    dup = 3
    v0, v1, v2 = (np.concatenate([x, x[dup:dup + 1]]) for x in (v0, v1, v2))
    assert v0.shape[0] == 13
    o, d = _aimed_rays(v0[dup:dup + 1], v1[dup:dup + 1], v2[dup:dup + 1],
                       64, seed=3)
    v0, v1, v2, o, d = _t(v0, v1, v2, o, d)
    h, t, i = K.intersect_nearest(o, d, K.pack_tris(v0, v1, v2))
    bh, _, bi, _, _ = brute_force_nearest(o, d, v0, v1, v2)
    on_dup = bh & (bi == dup)
    assert int(on_dup.sum()) >= 8
    assert torch.equal(i[on_dup], bi[on_dup])
    assert not (i == 12).any()


def test_eps_decides_the_near_hit():
    """A hit at t = 5e-4 counts with eps 1e-6 and not with eps 1e-3, in
    the plain K3 as in brute_force_nearest."""
    v0 = torch.tensor([[-1.0, -1.0, 0.0]])
    v1 = torch.tensor([[1.0, -1.0, 0.0]])
    v2 = torch.tensor([[0.0, 1.0, 0.0]])
    o = torch.tensor([[0.0, 0.0, 5e-4], [0.0, 0.0, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    tris = K.pack_tris(v0, v1, v2)
    for eps, want in ((1e-6, [True, True]), (1e-3, [False, True])):
        h, t, i = K.intersect_nearest(o, d, tris, eps)
        bh, bt, _, _, _ = brute_force_nearest(o, d, v0, v1, v2, eps)
        assert h.tolist() == bh.tolist() == want, eps
        np.testing.assert_allclose(t[h].numpy(), bt[h].numpy(), rtol=T_RTOL)


def test_wrapper_dispatch_and_bad_inputs():
    v = tuple(torch.as_tensor(x) for x in _box_corners())
    tris = K.pack_tris(*v)
    o, d = _t(*_rays(64))
    K.reset_launch_counts()
    got = K.intersect_nearest(o, d, tris)
    want = K.intersect_nearest_reference(o, d, tris)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K.launch_counts == {"nearest": 0}
    # No rays, and an empty table (every ray misses).
    h, t, i = K.intersect_nearest(o[:0], d[:0], tris)
    assert h.shape == t.shape == i.shape == (0,)
    h, t, i = K.intersect_nearest(o, d, tris[:0])
    assert not h.any() and (t == np.float32(K.T_MAX)).all() and not i.any()
    with pytest.raises(TypeError, match="float32"):
        K.intersect_nearest(o.double(), d, tris)
    with pytest.raises(TypeError, match="float32"):
        K.intersect_nearest(o, d, tris.double())
    with pytest.raises(ValueError, match="128"):
        K.intersect_nearest(o, d, tris.reshape(-1, 64))
    with pytest.raises(ValueError, match="shape"):
        K.intersect_nearest(o, d[:5], tris)
    with pytest.raises(ValueError, match="unsupported device"):
        K.intersect_nearest(o.to("meta"), d.to("meta"), tris.to("meta"))
    with pytest.raises(ValueError):
        convert.intersect_table_from_arrays(np.zeros((2, 64), np.float32),
                                            device="cpu")


def test_render_sample_intersect_matches_none():
    scene = T.cornell_box_scene(device="cpu")
    cam = T.OrbitCamera().view_update(120.0, -60.0).zoom_update(0.9).camera(
        "cpu")
    cfg = T.RenderConfig(width=12, height=12, max_depth=2, spp=1,
                         enable_sss=False, remat_bounces=False)
    img_n = T.render_sample(scene, cam, cfg, 0)
    img_k = T.render_sample(scene, cam, cfg.replace(kernels="intersect"), 0)
    assert float(img_k.max()) > 0.0
    np.testing.assert_allclose(img_k.numpy(), img_n.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_every_nearest_query_is_one_k3_call(monkeypatch):
    """box512's recipe (4 bounces, SSS 3 steps, Russian roulette) at 8²,
    2 spp: per sub-sample, the primary, one nearest per bounce after the
    first (bounce 0 reuses the primary) and one per SSS step, each one K3
    call; the table is packed once per render_sample."""
    cfg = T.preset("box512", width=8, height=8, spp=2, kernels="intersect")
    calls = {"nearest": 0, "pack": 0}
    nearest, pack = K.intersect_nearest, K.pack_tris

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(K, "intersect_nearest", counted("nearest", nearest))
    monkeypatch.setattr(K, "pack_tris", counted("pack", pack))
    img = T.render_sample(T.cornell_box_scene(device="cpu"),
                          T.OrbitCamera().camera("cpu"), cfg, 0)
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0.0
    per_spp = 1 + (cfg.max_depth - 1) + cfg.max_depth * cfg.sss_bounces
    assert per_spp == 16
    assert calls == {"nearest": cfg.spp * per_spp, "pack": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["box", "sphere"])
def test_kernel_matches_plain_on_card(cuda, which):
    if which == "box":
        v = _box_corners()
        o, d = _rays(4096, seed=11)
    else:
        v = _corners(T.procedural_scene(n_tris_target=4000, device="cpu"))
        o, d = _aimed_rays(*v, 4096, seed=12)
    tris = K.pack_tris(*_t(*v)).to(cuda)
    o, d = (x.to(cuda) for x in _t(o, d))
    for eps in (1e-6, 1e-3):
        K.reset_launch_counts()
        kh, kt, ki = K.intersect_nearest(o, d, tris, eps)
        ph, pt, pi = K.intersect_nearest_reference(o, d, tris, eps)
        torch.cuda.synchronize()
        assert K.launch_counts == {"nearest": 1}
        assert kh.any()
        assert torch.equal(kh, ph) and torch.equal(ki, pi)
        assert torch.equal(kt, pt)


@pytest.mark.cuda
def test_kernel_empty_and_bad_inputs_on_card(cuda):
    tris = K.pack_tris(*_t(*_box_corners())).to(cuda)
    e = torch.zeros((0, 3), device=cuda)
    K.reset_launch_counts()
    h, t, i = K.intersect_nearest(e, e, tris)
    assert h.shape == (0,) and K.launch_counts == {"nearest": 0}
    o, d = (x.to(cuda) for x in _t(*_rays(300)))
    h, t, i = K.intersect_nearest(o, d, tris[:0])
    torch.cuda.synchronize()
    assert not h.any() and not i.any() and K.launch_counts == {"nearest": 1}
    with pytest.raises(ValueError, match="is on"):
        K.intersect_nearest(o, d, tris.cpu())
