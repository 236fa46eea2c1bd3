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
  - The wrapper's geometry rule (`_geometry`, `_blocks`): on phase 9's
    streams of chip_smoke.py and on 1 ray, 144 rays and 1 row, rays per
    thread, cluster blocks and threads lie in the built sets, the grid is a
    multiple of the cluster, every ray lies in exactly one cluster (the
    kernel's ray map) and every row in exactly one slice.
  - The merge rule of a cluster: the plain version run on each slice of a
    table (the rows keep their global ids) and merged in slice order by a
    strictly smaller t equals the plain version over the whole table, with
    duplicate triangles on both sides of every boundary.
  - Tests marked `cuda` hold the kernel to the plain version exactly (hit,
    tri and t) on the card, through the wrapper and in every geometry, at
    ray counts around the geometries' block sizes, tables around the
    16-row tile and 465 rows, ties across a tile and a slice boundary, and
    both eps values; they skip without one.
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


def _sphere_corners():
    """The 3,720 triangles of chip_smoke.py's K3 sphere (465 table rows)."""
    return _corners(T.procedural_scene(n_tris_target=4000, device="cpu"))


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
    # A geometry the kernel is not built for raises before any build.
    with pytest.raises(ValueError, match="no geometry"):
        K._launch(o, d, tris, 1e-6, (3, 1, 128))
    assert K.launch_counts == {"nearest": 0}
    with pytest.raises(ValueError):
        convert.intersect_table_from_arrays(np.zeros((2, 64), np.float32),
                                            device="cpu")


def _kernel_ray_map(blocks, g):
    """The rays block b of a launch holds (csrc/intersect_nearest.cu
    `intersect_nearest_kernel`): (b / S) R T + j T + x for thread x < T and
    j < R, the same rays in every block of a cluster."""
    R, S, T = g
    b = np.arange(blocks)[:, None, None]
    j = np.arange(R)[None, :, None]
    x = np.arange(T)[None, None, :]
    return (b // S) * R * T + j * T + x


def _kernel_slices(n_rows, S):
    """The rows [begin, end) block q of a cluster scans (the kernel's
    q n / S split)."""
    return [(q * n_rows // S, (q + 1) * n_rows // S) for q in range(S)]


@pytest.mark.parametrize("n_rays, n_rows", [
    (1 << 16, 465), (512 * 512, 2), (1 << 16, 2),
    (1, 465), (1, 2), (144, 465), (144, 2), (1 << 16, 1), (1, 1),
    # ray counts off every block size, on both sides of each crossover
    ((1 << 16) + 1, 3), (257, 3), ((1 << 17) - 1, 2)])
def test_geometry_rule_covers_every_ray_once(n_rays, n_rows):
    g = K._geometry(n_rays, n_rows)
    assert g.rays_per_thread in K.RAYS_PER_THREAD
    assert g.cluster in K.CLUSTER_BLOCKS and g.threads in K.THREADS
    blocks = K._blocks(n_rays, g)
    assert blocks > 0 and blocks % g.cluster == 0
    rays = _kernel_ray_map(blocks, g)
    for q in range(g.cluster):
        held = rays[q::g.cluster].ravel()
        held = held[held < n_rays]
        assert np.array_equal(np.sort(held), np.arange(n_rays)), q
    # No cluster is wholly past the last ray.
    assert rays[-1].min() < n_rays
    rows = np.concatenate([np.arange(a, e) for a, e in
                           _kernel_slices(n_rows, g.cluster)])
    assert np.array_equal(rows, np.arange(n_rows))


@pytest.mark.parametrize("n_rays, n_rows, want", [
    # chip_smoke.py phase 9's streams
    (512 * 512, 2, (2, 1, 256)), (1 << 16, 2, (2, 1, 256)),
    (1 << 16, 465, (2, 2, 256)),
    # the oracle render's 12^2 primary stream over the box
    (144, 2, (1, 1, 128)),
    # 2^16 rays over tables between the box's and the sphere's
    (1 << 16, 8, (2, 2, 256)), (1 << 16, 16, (2, 2, 256)),
    (1 << 16, 32, (2, 2, 256))])
def test_geometry_rule_picks_the_timed_fastest(n_rays, n_rows, want):
    """The rule's pick at the streams scripts/torch_k3_geometry.py timed
    on the card (PERF.md §6)."""
    assert tuple(K._geometry(n_rays, n_rows)) == want


def _tie_table(v0, v1, v2, copies, n):
    """n triangles: at each slot of `copies` the triangle of that index,
    the others in order at the remaining slots (those indices left out).
    A ray through a copied triangle ties at each of its copies."""
    keep = np.setdiff1d(np.arange(n), list(copies))
    rest = np.setdiff1d(np.arange(v0.shape[0]), list(copies.values()))
    out = []
    for x in (v0, v1, v2):
        y = np.empty((n, 3), np.float32)
        y[keep] = x[rest[:len(keep)]]
        y[list(copies)] = x[list(copies.values())]
        out.append(y)
    return out


def _rays_onto(v0, v1, v2, k, n, seed):
    """Rays onto random points of triangle k, from 0.05 along its normal on
    the side away from the origin: they hit it before anything else."""
    rng = np.random.default_rng(seed)
    a, b = rng.random((2, n, 1)) * 0.5
    p = v0[k] + a * (v1[k] - v0[k]) + b * (v2[k] - v0[k])
    nrm = np.cross(v1[k] - v0[k], v2[k] - v0[k])
    nrm *= np.sign(nrm @ v0[k]) / np.linalg.norm(nrm)
    o = p + 0.05 * nrm
    d = p - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _merge_slices(o, d, tris, bounds, eps):
    """The plain version on each slice [a, e) of the table's rows, merged
    in slice order by a strictly smaller t: the kernel's cluster merge."""
    best_t = torch.full((o.shape[0],), K.T_MAX)
    best_i = torch.zeros((o.shape[0],), dtype=torch.int32)
    for a, e in bounds:
        _, t, i = K.intersect_nearest_reference(o, d, tris[a:e], eps)
        take = t < best_t
        best_t = torch.where(take, t, best_t)
        best_i = torch.where(take, i, best_i)
    return best_t < K.T_MAX, best_t, best_i


@pytest.mark.parametrize("S", [2, 3, 4])
def test_cluster_merge_equals_whole_table(S):
    """Slices of a 40-row table at the kernel's split for S blocks, with
    triangle 0 copied to the last slot before and the first slot after
    every boundary: the merge equals the whole table's scan, and every tie
    goes to the lower id."""
    n_rows = 40
    bounds = _kernel_slices(n_rows, S)
    dups = {8 * a + k: 0 for a, _ in bounds[1:] for k in (-1, 0)}
    v0, v1, v2 = _tie_table(*_sphere_corners(), {0: 0, **dups}, 8 * n_rows)
    tris = K.pack_tris(*_t(v0, v1, v2))
    assert tris.shape == (n_rows, 128)
    o, d = _rays_onto(v0, v1, v2, 0, 64, seed=5)
    o2, d2 = _aimed_rays(v0, v1, v2, 192, seed=6)
    o, d = _t(np.concatenate([o, o2]), np.concatenate([d, d2]))
    for eps in (1e-6, 1e-3):
        want = K.intersect_nearest_reference(o, d, tris, eps)
        got = _merge_slices(o, d, tris, bounds, eps)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), eps
        # The rays onto triangle 0 hit it first at slot 0, ahead of every
        # copy at the boundaries.
        assert bool(want[0][:64].all()) and not want[2][:64].any()
    # Without slot 0's copy in the first slice, the tie at each boundary
    # goes to the copy before it.
    for a, _ in bounds[1:]:
        _, _, i = _merge_slices(o[:64], d[:64], tris[a - 1:], [
            (0, 1), (1, tris.shape[0] - a + 1)], 1e-6)
        _, _, i_ref = K.intersect_nearest_reference(o[:64], d[:64],
                                                    tris[a - 1:], 1e-6)
        assert torch.equal(i, i_ref)
        assert bool((i == 8 * a - 1).all())


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

def _hold_every_geometry(o, d, tris, eps):
    """K3 in every geometry ≡ the plain version (hit, tri, t) on the card:
    the plain hit and tri."""
    ph, pt, pi = K.intersect_nearest_reference(o, d, tris, eps)
    K.reset_launch_counts()
    for g in K.GEOMETRIES:
        kt, ki = K._launch(o, d, tris, eps, g)
        torch.cuda.synchronize()
        assert torch.equal(kt < K.T_MAX, ph), g
        assert torch.equal(ki, pi), g
        assert torch.equal(kt, pt), g
    assert K.launch_counts == {"nearest": len(K.GEOMETRIES)}
    return ph, pi


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows",
                         [1, 2, 15, 16, 17, 31, 32, 33, 47, 48, 49, 465])
def test_every_geometry_exact_on_card(cuda, n_rows):
    """Tables of 1 and 2 rows, around the 16-row tile (unsplit, and in
    each slice of a 2-block cluster), around the 3-tile ring and the
    sphere's 465 rows;
    1, 127, 129, R x threads +- 1 of every geometry and 65,537 rays; both
    eps values."""
    v0, v1, v2 = (x[:8 * n_rows] for x in _sphere_corners())
    tris = K.pack_tris(*_t(v0, v1, v2)).to(cuda)
    assert tris.shape == (n_rows, 128)
    o_all, d_all = _aimed_rays(v0, v1, v2, 65_537, seed=13)
    counts = sorted({1, 127, 129, 65_537}
                    | {r * t + k for r in K.RAYS_PER_THREAD
                       for t in K.THREADS for k in (-1, 1)})
    for n in counts:
        o, d = (torch.as_tensor(x[:n]).to(cuda) for x in (o_all, d_all))
        for eps in (1e-6, 1e-3):
            hit, _ = _hold_every_geometry(o, d, tris, eps)
            assert n < 127 or bool(hit.any()), (n, eps)


@pytest.mark.cuda
def test_ties_across_tile_and_slice_boundaries_on_card(cuda):
    """465 rows with one triangle copied to both sides of each boundary: a
    tile's (row 16), the 3-tile ring's wrap (row 48), the slices' of a
    2-block cluster (row 232) and the second tile of its slice 1 (row
    248); rays onto each pair tie, and every geometry gives the lower id,
    as the plain version does."""
    n_rows = 465
    boundaries = (16, 48, 232, 248)
    sources = (101, 202, 303, 404)
    copies = {8 * b + k: src for b, src in zip(boundaries, sources)
              for k in (-1, 0)}
    v0, v1, v2 = _tie_table(*_sphere_corners(), copies, 8 * n_rows)
    tris = K.pack_tris(*_t(v0, v1, v2)).to(cuda)
    rays = [_rays_onto(v0, v1, v2, 8 * b - 1, 64, seed=20 + b)
            for b in boundaries]
    o, d = (torch.as_tensor(np.concatenate(x)).to(cuda)
            for x in zip(*rays))
    for eps in (1e-6, 1e-3):
        hit, tri = _hold_every_geometry(o, d, tris, eps)
        want = np.repeat([8 * b - 1 for b in boundaries], 64)
        assert bool(hit.all())
        np.testing.assert_array_equal(tri.cpu().numpy(), want)


@pytest.mark.cuda
def test_geometry_and_grid_refused_on_card(cuda):
    """A geometry the kernel is not built for raises before any launch; a
    grid that does not cover the rays once is refused by the library."""
    from dpt_tpu_torch.kernels.build import launch_intersect

    tris = K.pack_tris(*_t(*_box_corners())).to(cuda)
    o, d = (x.to(cuda) for x in _t(*_rays(300)))
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="no geometry"):
        K._launch(o, d, tris, 1e-6, (3, 1, 128))
    g = K.Geometry(2, 2, 128)
    with pytest.raises(RuntimeError, match="launch failed"):
        launch_intersect(o, d, tris, 1e-6, g, K._blocks(300, g) + 2)
    assert K.launch_counts == {"nearest": 0}
