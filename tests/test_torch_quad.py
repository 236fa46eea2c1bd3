"""dpt_tpu_torch 4-wide BVH: host tables and the walk ≡ dpt_tpu.

  - The numpy BVH builders and `pack_quad` give byte-identical tables.
  - The plain PyTorch walk (what a CPU tensor runs) matches the JAX quad
    kernel, run in Pallas interpret mode as tests/test_pallas_quad.py runs
    it: hit and occluded exact, t allclose (rtol 1e-5, atol 1e-6), tri
    exact except at equal-t ties (the TPU kernel breaks ties by its
    tile-wide visit order, the port by the ray's own).
  - The plain walk's per-ray visit counts (`stats["ray_visits"]`, which
    chip_smoke.py turns into lane utilisation) on a hand-built chain.
  - Tests marked `cuda` compare the CUDA kernel with the plain walk on the
    card, exactly, in both designs (one ray per lane, one per group of
    four lanes): streams of several waves, of 1, 31 and 33 rays,
    all-masked occluded streams, a tree at the stack guard's depth and the
    wrapper's switch-over size; they skip without one.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.accel import bvh as tb
from dpt_tpu_torch.kernels import quad as tq
from dpt_tpu_torch.render.intersect import brute_force_nearest, moller_trumbore
from dpt_tpu_torch.scene.builder import knot_scene

torch.set_num_threads(2)
CFG = T.RenderConfig()
N_RAYS = 384

# case -> (scene kind, builder, leaf size)
CASES = {
    "box-median4": ("box", "median", 4),
    "sphere-sah8": ("sphere", "sah", 8),
    "knot-sah8": ("knot", "sah", 8),
    "single-leaf": ("tiny", "median", 8),
}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import dpt_tpu
    from dpt_tpu.accel import bvh
    from dpt_tpu.kernels import pallas_quad

    return types.SimpleNamespace(
        jnp=jnp, bvh=bvh, quad=pallas_quad,
        cfg=dpt_tpu.RenderConfig(packet_tile=1024, interleave=1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(kind):
    if kind == "box":
        return T.cornell_box_scene(device="cpu")
    if kind == "sphere":
        return T.procedural_scene(n_tris_target=2_000, device="cpu")
    if kind == "knot":
        return knot_scene(n_tris_target=2_000, device="cpu")
    return T.procedural_scene(n_tris_target=8, device="cpu")


def _corners(scene):
    v = scene.vertices.numpy()
    idx = scene.indices.numpy()
    return v, idx, (v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]])


def _port_tables(case):
    kind, builder, leaf = CASES[case]
    scene = _scene(kind)
    v, idx, corners = _corners(scene)
    build = tb.build_bvh_median if builder == "median" else tb.build_bvh_sah
    bvh = build(v, idx, leaf_size=leaf)
    return scene, bvh, tq.pack_quad(bvh, *corners, device="cpu")


def _jax_tables(jx, case, scene):
    _, builder, leaf = CASES[case]
    v, idx, corners = _corners(scene)
    build = (jx.bvh.build_bvh_median if builder == "median"
             else jx.bvh.build_bvh_sah)
    bvh = build(v, idx, leaf_size=leaf, use_native=False)
    return bvh, jx.quad.pack_quad(bvh, *corners)


def _rays(n, seed, spread):
    """Random rays plus axis-aligned ones (zero direction components) and
    two masked lanes (origin 1e9, direction +z, max_dist -1)."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if n >= 16:
        axes = np.concatenate([np.eye(3), -np.eye(3)])
        d[:12] = np.concatenate([axes, axes])
        o[:12] *= 0.1
    d = d.astype(np.float32)
    md = rng.uniform(-0.5, 3.0 * spread, n).astype(np.float32)
    o[-2:] = 1e9
    d[-2:] = [0.0, 0.0, 1.0]
    md[-2:] = -1.0
    return torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(md)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bvh_builders_identical(jx, case):
    scene, bvh_t, _ = _port_tables(case)
    bvh_j, _ = _jax_tables(jx, case, scene)
    for f in ("node_min", "node_max", "node_left", "node_right", "tri_order"):
        a, b = np.asarray(getattr(bvh_j, f)), getattr(bvh_t, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("builder", ["median", "sah"])
def test_bvh_builders_identical_other_leaf_sizes(jx, builder):
    scene = T.procedural_scene(n_tris_target=1_500, device="cpu")
    v, idx, _ = _corners(scene)
    for leaf in (1, 3):
        jb = getattr(jx.bvh, f"build_bvh_{builder}")(v, idx, leaf_size=leaf,
                                                     use_native=False)
        pb = getattr(tb, f"build_bvh_{builder}")(v, idx, leaf_size=leaf)
        for f in ("node_min", "node_max", "node_left", "node_right",
                  "tri_order"):
            np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                          getattr(pb, f))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_quad_byte_identical(jx, case):
    scene, _, acc_t = _port_tables(case)
    _, acc_j = _jax_tables(jx, case, scene)
    assert acc_t.nodes_flat.numpy().tobytes() == np.asarray(
        acc_j.nodes_flat).tobytes()
    assert acc_t.tris.numpy().tobytes() == np.asarray(acc_j.tris).tobytes()
    assert (acc_t.n_wide, acc_t.max_depth) == (acc_j.n_wide, acc_j.max_depth)


def _check_ties(o, d, scene, t_port, tri_port, tri_ref, hit):
    """Where the chosen triangles differ, both must give the same t."""
    diff = hit & (tri_port != tri_ref)
    if not diff.any():
        return
    v0, v1, v2 = scene.tri_vertices()
    for tri in (tri_port, tri_ref):
        k = tri[diff].long()
        h, t, _, _ = moller_trumbore(o[diff], d[diff], v0[k], v1[k], v2[k])
        assert h.all()
        np.testing.assert_allclose(t.numpy(), t_port[diff].numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_walk_tables(jx):
    """case -> (scene, port tables, JAX tables).  The JAX tables are padded
    with unreachable NaN-boxed records and zero leaf rows to one common
    shape, with common static n_wide / max_depth, so the interpreted kernel
    compiles once per mode for all cases."""
    out = {}
    for case in CASES:
        scene, _, acc_t = _port_tables(case)
        out[case] = (scene, acc_t, _jax_tables(jx, case, scene)[1])
    w = max(a.n_wide for _, _, a in out.values())
    w = -(-w // 4) * 4
    rows_t = max(a.tris.shape[0] for _, _, a in out.values())
    depth = max(a.max_depth for _, _, a in out.values())
    empty = np.zeros(32, np.float32)
    empty[:24] = np.nan

    def pad(acc_j):
        flat = np.asarray(acc_j.nodes_flat).reshape(-1, 32)
        flat = np.concatenate([flat, np.tile(empty, (w - len(flat), 1))])
        tris = np.asarray(acc_j.tris)
        tris = np.concatenate(
            [tris, np.zeros((rows_t - len(tris), 128), np.float32)])
        return dataclasses.replace(
            acc_j, nodes=jx.jnp.asarray(flat.reshape(-1, 128)),
            nodes_flat=jx.jnp.asarray(flat.reshape(-1)),
            tris=jx.jnp.asarray(tris), n_wide=w, max_depth=depth)

    return {c: (scene, acc_t, pad(acc_j))
            for c, (scene, acc_t, acc_j) in out.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_walk_matches_jax_kernel(jx, jax_walk_tables, case):
    scene, acc_t, acc_j = jax_walk_tables[case]
    spread = 3.0 if case == "box-median4" else 1.5
    o, d, md = _rays(N_RAYS, seed=len(case), spread=spread)
    jo, jd, jmd = (jx.jnp.asarray(x.numpy()) for x in (o, d, md))

    jh, jt, ji = (torch.as_tensor(np.array(x)) for x in
                  jx.quad.quad_nearest(jo, jd, acc_j, jx.cfg))
    th, tt, ti = tq.quad_nearest(o, d, acc_t, CFG)
    assert th.dtype == torch.bool and ti.dtype == torch.int32
    assert torch.equal(th, jh)
    assert th.any() and not th.all()
    np.testing.assert_allclose(tt[th].numpy(), jt[th].numpy(), rtol=1e-5,
                               atol=1e-6)
    _check_ties(o, d, scene, tt, ti, ji, th)

    jocc = torch.as_tensor(np.array(
        jx.quad.quad_occluded(jo, jd, jmd, acc_j, jx.cfg)))
    tocc = tq.quad_occluded(o, d, md, acc_t, CFG)
    assert torch.equal(tocc, jocc)
    assert not tocc[md <= 0].any()


def test_plain_walk_matches_brute_force():
    scene, _, acc = _port_tables("knot-sah8")
    o, d, _ = _rays(2048, seed=21, spread=1.5)
    v0, v1, v2 = scene.tri_vertices()
    bh, bt, bi, _, _ = brute_force_nearest(o, d, v0, v1, v2)
    qh, qt, qi = tq.quad_nearest(o, d, acc, CFG)
    assert torch.equal(bh, qh)
    np.testing.assert_allclose(qt[bh].numpy(), bt[bh].numpy(), rtol=1e-5,
                               atol=1e-6)
    _check_ties(o, d, scene, qt, qi, bi, bh)


def _three_tri_bvh():
    """Root -> (leaf [tri 0], internal -> (leaf [tri 1], leaf [tri 2])):
    the root record holds a leaf in slot 0 and an EMPTY slot 1 (NaN box,
    pointer 0 — the root's own id) beside it."""
    v = np.array([[-2.0, -0.5, 0.0], [-1.0, -0.5, 0.0], [-1.5, 0.5, 0.0],
                  [0.0, -0.5, 0.5], [1.0, -0.5, 0.5], [0.5, 0.5, 0.5],
                  [1.5, -0.5, -0.5], [2.5, -0.5, -0.5], [2.0, 0.5, -0.5]],
                 np.float32)
    idx = np.arange(9, dtype=np.int32).reshape(3, 3)
    tri = v[idx]
    tmin, tmax = tri.min(axis=1), tri.max(axis=1)
    node_min = np.stack([tmin.min(0), tmin[0], tmin[1:].min(0), tmin[1],
                         tmin[2]])
    node_max = np.stack([tmax.max(0), tmax[0], tmax[1:].max(0), tmax[1],
                         tmax[2]])
    fields = dict(
        node_min=node_min.astype(np.float32),
        node_max=node_max.astype(np.float32),
        node_left=np.array([1, -1, 3, -1, -1], np.int32),
        node_right=np.array([2, 0, 4, 1, 2], np.int32),
        tri_order=np.arange(3, dtype=np.int32),
    )
    return v, idx, fields


def test_empty_slots_beside_leaves(jx):
    v, idx, fields = _three_tri_bvh()
    corners = (v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]])
    acc_t = tq.pack_quad(tb.BVH(**fields), *corners, device="cpu")
    acc_j = jx.quad.pack_quad(jx.bvh.BVH(**fields), *corners)
    assert acc_t.nodes_flat.numpy().tobytes() == np.asarray(
        acc_j.nodes_flat).tobytes()
    root = acc_t.nodes_flat.view(-1, 32)[0]
    assert root[24] < 0 and torch.isnan(root[6:12]).all() and root[25] == 0

    # Rays through every triangle, from both sides and along the axes.
    rng = np.random.default_rng(8)
    n = 256
    target = v[idx[rng.integers(0, 3, n)]].mean(axis=1)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    d[n // 2:] = rng.normal(size=(n - n // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = torch.as_tensor((target - 3.0 * d).astype(np.float32))
    d = torch.as_tensor(d.astype(np.float32))
    scene = T.Scene(vertices=torch.as_tensor(v), indices=torch.as_tensor(idx),
                    uvs=torch.zeros((3, 3, 2)),
                    mat_idx=torch.zeros(3, dtype=torch.int32),
                    materials=T.Materials.default(device="cpu"),
                    lights=T.default_lights(device="cpu"))
    v0, v1, v2 = scene.tri_vertices()
    bh, bt, bi, _, _ = brute_force_nearest(o, d, v0, v1, v2)
    qh, qt, qi = tq.quad_nearest(o, d, acc_t, CFG)
    assert bh[: n // 2].all()
    assert torch.equal(bh, qh) and torch.equal(bi[bh], qi[bh])
    jh, jt, ji = jx.quad.quad_nearest(jx.jnp.asarray(o.numpy()),
                                      jx.jnp.asarray(d.numpy()), acc_j,
                                      jx.cfg)
    assert torch.equal(qh, torch.as_tensor(np.array(jh)))
    assert torch.equal(qi, torch.as_tensor(np.array(ji)))
    md = torch.full((n,), 10.0)
    assert torch.equal(tq.quad_occluded(o, d, md, acc_t, CFG), bh)


def test_nan_box_never_passes_slab():
    rec = torch.full((6, 32), float("nan"))
    d = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                      [0.577, 0.577, 0.577], [-0.0, 0.0, -1.0],
                      [1.0, 1.0, 0.0]])
    o = torch.zeros((6, 3))
    inv = tq._safe_inv(d)
    assert torch.isfinite(inv).all()
    tn, tf = tq._slab(rec, 0, (o[:, 0], o[:, 1], o[:, 2],
                               inv[:, 0], inv[:, 1], inv[:, 2]))
    assert not ((tn <= tf) & (tf >= 0.0)).any()


def test_masked_lanes_and_empty_stream():
    _, _, acc = _port_tables("sphere-sah8")
    o = torch.full((5, 3), 1e9)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(5, 1)
    h, t, i = tq.quad_nearest(o, d, acc, CFG)
    assert not h.any() and (t == 1e30).all() and (i == 0).all()
    occ = tq.quad_occluded(o, d, torch.full((5,), -1.0), acc, CFG)
    assert not occ.any()
    # max_dist <= 0 is never occluded, even for a ray that hits.
    o2 = torch.tensor([[0.0, 0.0, -3.0]])
    d2 = torch.tensor([[0.0, 0.0, 1.0]])
    assert tq.quad_nearest(o2, d2, acc, CFG)[0].all()
    assert tq.quad_occluded(o2, d2, torch.tensor([10.0]), acc, CFG).all()
    assert not tq.quad_occluded(o2, d2, torch.tensor([0.0]), acc, CFG).any()

    e = torch.zeros((0, 3))
    h, t, i = tq.quad_nearest(e, e, acc, CFG)
    assert h.shape == t.shape == i.shape == (0,)
    assert (h.dtype, t.dtype, i.dtype) == (torch.bool, torch.float32,
                                           torch.int32)
    occ = tq.quad_occluded(e, e, torch.zeros(0), acc, CFG)
    assert occ.shape == (0,) and occ.dtype == torch.bool


def test_stack_guard():
    _, _, acc = _port_tables("box-median4")
    o, d, _ = _rays(8, seed=1, spread=3.0)
    with pytest.raises(ValueError, match="stack_depth"):
        tq.quad_nearest(o, d, acc, CFG.replace(bvh_stack_depth=1))
    with pytest.raises(ValueError, match="stack_depth"):
        tq.quad_occluded(o, d, torch.ones(8), acc,
                         CFG.replace(bvh_stack_depth=1))
    # The kernel's fixed capacity bounds the depth whatever the config says.
    deep = dataclasses.replace(acc, max_depth=21)  # needs 65 > 64 slots
    with pytest.raises(ValueError, match="kernel capacity"):
        tq.quad_nearest(o, d, deep, CFG.replace(bvh_stack_depth=128))


def test_wrapper_rejects_bad_inputs():
    _, _, acc = _port_tables("box-median4")
    o, d, md = _rays(8, seed=2, spread=3.0)
    with pytest.raises(TypeError, match="float32"):
        tq.quad_nearest(o.double(), d, acc, CFG)
    with pytest.raises(ValueError, match="shape"):
        tq.quad_occluded(o, d, md[:4], acc, CFG)
    # Neither CPU nor CUDA: no walk at all, never a silent fallback.
    with pytest.raises(ValueError, match="unsupported device"):
        tq.quad_nearest(o.to("meta"), d.to("meta"), acc.to("meta"), CFG)


def test_cpu_walk_launches_no_kernel():
    _, _, acc = _port_tables("sphere-sah8")
    o, d, md = _rays(64, seed=3, spread=1.5)
    tq.reset_launch_counts()
    tq.quad_nearest(o, d, acc, CFG)
    tq.quad_occluded(o, d, md, acc, CFG)
    assert tq.launch_counts == {"nearest": 0, "occluded": 0}


def test_occluded_agrees_with_nearest():
    """The any-hit query reaches exactly the nearest hit: occluded at
    max_dist = t is false (no hit is strictly nearer), and occluded at the
    next float above t is the nearest query's hit."""
    _, _, acc = _port_tables("knot-sah8")
    o, d, _ = _rays(256, seed=5, spread=1.5)
    h, t, _ = tq.quad_nearest(o, d, acc, CFG)
    assert h.any() and not h.all()
    assert not tq.quad_occluded(o, d, t, acc, CFG).any()
    above = torch.nextafter(t, torch.full_like(t, float("inf")))
    assert torch.equal(tq.quad_occluded(o, d, above, acc, CFG), h)


def chain_bvh(n):
    """A binary BVH over 2n + 1 triangles with one yz footprint (the half
    of [-0.5, 0.5]^2 below y + z = 0) in planes x = const: chain node i
    (i < n) has the children L_i, an internal node over the leaves of the
    triangles at x = i + 0.25 and i + 0.5, and chain node i + 1; chain
    node n is the leaf of the triangle at x = n + 0.25.  A ray along -x
    walks down the chain first and pushes one record per level.  Returns
    (vertices, indices, accel.bvh.BVH); node 0 is the root."""
    xs = [x for i in range(n) for x in (i + 0.25, i + 0.5)] + [n + 0.25]
    v = np.array([[(x, -0.5, -0.5), (x, 0.5, -0.5), (x, -0.5, 0.5)]
                  for x in xs], np.float32).reshape(-1, 3)
    idx = np.arange(v.shape[0], dtype=np.int32).reshape(-1, 3)
    tmin, tmax = v[idx].min(axis=1), v[idx].max(axis=1)
    lo, hi, left, right = [], [], [], []

    def node(lft, rgt, mn, mx):
        lo.append(mn)
        hi.append(mx)
        left.append(lft)
        right.append(rgt)
        return len(lo) - 1

    def inner(me, a, b):
        left[me], right[me] = a, b
        lo[me], hi[me] = np.minimum(lo[a], lo[b]), np.maximum(hi[a], hi[b])

    def chain(i):
        if i == n:
            return node(-1, 2 * n, tmin[2 * n], tmax[2 * n])
        me, pair = node(0, 0, None, None), node(0, 0, None, None)
        inner(pair, *(node(-1, k, tmin[k], tmax[k])
                      for k in (2 * i, 2 * i + 1)))
        inner(me, pair, chain(i + 1))
        return me

    chain(0)
    return v, idx, tb.BVH(
        node_min=np.array(lo, np.float32), node_max=np.array(hi, np.float32),
        node_left=np.array(left, np.int32),
        node_right=np.array(right, np.int32),
        tri_order=np.arange(idx.shape[0], dtype=np.int32))


def chain_rays(n_rays, n, seed):
    """Rays along +x from x = -1 and along -x from x = n + 2, through the
    footprint square, slightly tilted; half hit a triangle."""
    rng = np.random.default_rng(seed)
    sign = np.where(np.arange(n_rays) % 2 == 0, 1.0, -1.0)
    o = np.stack([np.where(sign > 0, -1.0, n + 2.0),
                  *rng.uniform(-0.45, 0.45, (2, n_rays))], axis=1)
    d = np.concatenate([sign[:, None],
                        rng.normal(0.0, 0.01, (n_rays, 2))], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    md = rng.uniform(-0.5, n + 3.0, n_rays)
    return tuple(torch.as_tensor(x.astype(np.float32)) for x in (o, d, md))


def _chain_accel(n):
    v, idx, bvh = chain_bvh(n)
    return v, idx, tq.pack_quad(bvh, v[idx[:, 0]], v[idx[:, 1]],
                                v[idx[:, 2]], device="cpu")


def test_plain_walk_counts_visits_per_ray():
    """A ray that misses the root's boxes visits the root record only; a
    ray along -x inside every box that misses every triangle visits every
    record; a masked lane visits none; the counts sum to node_visits and
    the results are the walk's without stats."""
    _, _, acc = _chain_accel(3)
    o = torch.tensor([[-1.0, 2.0, 2.0], [6.0, 0.3, 0.3], [-1.0, -0.3, -0.3],
                      [6.0, -0.3, -0.3]])
    d = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                      [-1.0, 0.0, 0.0]])
    md = torch.tensor([10.0, 10.0, -1.0, 10.0])
    for occluded in (False, True):
        stats = {}
        got = tq._walk_reference(o, d, md, acc, occluded, 64, stats=stats)
        want = tq._walk_reference(o, d, md, acc, occluded, 64)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        visits = stats["ray_visits"]
        assert visits.dtype == torch.int64 and visits.shape == (4,)
        assert visits[0] == 1 and visits[1] == acc.n_wide == 3
        assert int(visits.sum()) == stats["node_visits"]
        assert (visits[2] == 0) == occluded


def test_plain_walk_at_stack_guard_depth():
    """The deepest quad tree the kernel's stack takes (3 * 20 + 2 = 62 of
    64 slots) walks like brute force; one level deeper is refused."""
    v, idx, acc = _chain_accel(39)
    assert acc.max_depth == 20
    o, d, md = chain_rays(256, 39, seed=4)
    cfg = CFG.replace(bvh_stack_depth=64)
    h, t, i = tq.quad_nearest(o, d, acc, cfg)
    corners = (torch.as_tensor(v[idx[:, k]]) for k in range(3))
    bh, bt, bi, _, _ = brute_force_nearest(o, d, *corners)
    assert torch.equal(h, bh) and h.any() and not h.all()
    assert torch.equal(i, bi)
    np.testing.assert_allclose(t[h].numpy(), bt[h].numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(tq.quad_occluded(o, d, md, acc, cfg),
                       bh & (bt < md) & (md > 0))
    with pytest.raises(ValueError, match="kernel capacity"):
        tq.quad_nearest(o, d, _chain_accel(40)[2],
                        CFG.replace(bvh_stack_depth=128))


def _card_matches_plain(acc, o, d, md, cfg=CFG):
    """K1 on the card equals the plain walk exactly, in the design the
    wrapper picks and in each design forced, one launch per call."""
    ph, pt, pi = tq.quad_nearest_reference(o, d, acc, cfg)
    po = tq.quad_occluded_reference(o, d, md, acc, cfg)
    tq.reset_launch_counts()
    kh, kt, ki = tq.quad_nearest(o, d, acc, cfg)
    ko = tq.quad_occluded(o, d, md, acc, cfg)
    torch.cuda.synchronize()
    assert tq.launch_counts == {"nearest": 1, "occluded": 1}
    assert torch.equal(kh, ph) and torch.equal(kt, pt)
    assert torch.equal(ki, pi) and torch.equal(ko, po)
    for design in ("lane", "group"):
        kt, ki = tq._launch(o, d, None, acc, False, design)
        _, ko = tq._launch(o, d, md, acc, True, design)
        torch.cuda.synchronize()
        assert torch.equal(kt, pt) and torch.equal(ki, pi)
        assert torch.equal(ko.bool(), po)
    return ph, po


@pytest.mark.cuda
@pytest.mark.parametrize("above", [0, 1])
def test_both_designs_at_the_switch_over_on_card(cuda, above):
    """GROUP_MAX_RAYS is the largest stream the wrapper walks in groups;
    one ray more goes one ray per lane."""
    _, _, acc = _port_tables("sphere-sah8")
    n = tq.GROUP_MAX_RAYS + above
    o, d, md = (x.to(cuda) for x in _rays(n, seed=37, spread=1.5))
    acc = acc.to(cuda)
    tq.reset_launch_counts()
    tq.quad_nearest(o, d, acc, CFG)
    tq.quad_occluded(o, d, md, acc, CFG)
    want = "lane" if above else "group"
    assert tq.design_counts == {"lane": 0, "group": 0, want: 2}
    _card_matches_plain(acc, o, d, md)


@pytest.mark.cuda
def test_kernel_several_waves_on_card(cuda):
    """A stream of three waves of resident lanes and a ragged end."""
    from dpt_tpu_torch.kernels.build import kernel_attributes

    _, _, acc = _port_tables("sphere-sah8")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    lanes = max(kernel_attributes("quad_traverse", m)["blocks_per_sm"]
                for m in (False, True)) * 128 * sms
    o, d, md = (x.to(cuda) for x in _rays(3 * lanes + 5, seed=33, spread=1.5))
    kh, ko = _card_matches_plain(acc.to(cuda), o, d, md)
    assert kh.any() and not kh.all() and ko.any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [1, 31, 33])
def test_kernel_small_streams_on_card(cuda, n_rays):
    _, _, acc = _port_tables("knot-sah8")
    o, d, md = _rays(64, seed=34, spread=1.5)
    o, d, md = (x[16:16 + n_rays].to(cuda) for x in (o, d, md))
    _card_matches_plain(acc.to(cuda), o, d, md)


@pytest.mark.cuda
def test_kernel_all_masked_occluded_on_card(cuda):
    _, _, acc = _port_tables("sphere-sah8")
    o, d, _ = _rays(5000, seed=35, spread=1.5)
    md = torch.where(torch.arange(5000) % 2 == 0, 0.0, -1.0)
    o, d, md = (x.to(cuda) for x in (o, d, md))
    _, ko = _card_matches_plain(acc.to(cuda), o, d, md)
    assert not ko.any()


@pytest.mark.cuda
def test_kernel_at_stack_guard_depth_on_card(cuda):
    _, _, acc = _chain_accel(39)
    o, d, md = (x.to(cuda) for x in chain_rays(4096, 39, seed=36))
    kh, _ = _card_matches_plain(acc.to(cuda), o, d, md,
                                CFG.replace(bvh_stack_depth=64))
    assert kh.any() and not kh.all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_walk_on_card(cuda, case):
    _, _, acc = _port_tables(case)
    acc = acc.to(cuda)
    spread = 3.0 if case == "box-median4" else 1.5
    o, d, md = (x.to(cuda) for x in _rays(4096, seed=31, spread=spread))
    tq.reset_launch_counts()
    kh, kt, ki = tq.quad_nearest(o, d, acc, CFG)
    ko = tq.quad_occluded(o, d, md, acc, CFG)
    torch.cuda.synchronize()
    assert tq.launch_counts == {"nearest": 1, "occluded": 1}
    ph, pt, pi = tq.quad_nearest_reference(o, d, acc, CFG)
    po = tq.quad_occluded_reference(o, d, md, acc, CFG)
    assert torch.equal(kh, ph) and torch.equal(kt, pt) and torch.equal(ki, pi)
    assert torch.equal(ko, po)
    assert tq.launch_counts == {"nearest": 1, "occluded": 1}


@pytest.mark.cuda
def test_kernel_masked_empty_and_bad_inputs_on_card(cuda):
    _, _, acc = _port_tables("sphere-sah8")
    acc = acc.to(cuda)
    o = torch.full((300, 3), 1e9, device=cuda)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=cuda).repeat(300, 1)
    md = torch.full((300,), -1.0, device=cuda)
    tq.reset_launch_counts()
    assert not tq.quad_nearest(o, d, acc, CFG)[0].any()
    assert not tq.quad_occluded(o, d, md, acc, CFG).any()
    e = torch.zeros((0, 3), device=cuda)
    assert tq.quad_nearest(e, e, acc, CFG)[0].shape == (0,)
    assert tq.launch_counts == {"nearest": 1, "occluded": 1}
    with pytest.raises(TypeError):
        tq.quad_nearest(o.double(), d, acc, CFG)
    with pytest.raises(ValueError):
        tq.quad_nearest(o, d, acc.to("cpu"), CFG)
