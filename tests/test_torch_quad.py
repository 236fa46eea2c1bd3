"""dpt_tpu_torch 4-wide BVH: host tables and the walk ≡ dpt_tpu.

  - The numpy BVH builders and `pack_quad` give byte-identical tables.
  - The plain PyTorch walk (what a CPU tensor runs) matches the JAX quad
    kernel, run in Pallas interpret mode as tests/test_pallas_quad.py runs
    it: hit and occluded exact, t allclose (rtol 1e-5, atol 1e-6), tri
    exact except at equal-t ties (the TPU kernel breaks ties by its
    tile-wide visit order, the port by the ray's own).
  - Tests marked `cuda` compare the CUDA kernel with the plain walk on the
    card, exactly; they skip without one.
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
