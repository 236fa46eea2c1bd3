"""dpt_tpu_torch paired-children BVH (K2): tables and the walk ≡ dpt_tpu.

  - `pack_wide` gives byte-identical tables (and the same n_internal and
    max_depth) on the box, sphere and knot scenes and the single-leaf tree.
  - The plain PyTorch walk (what a CPU tensor runs) matches the JAX
    paired-children kernel, run in Pallas interpret mode as
    tests/test_pallas_wide.py runs it: hit and occluded exact, t allclose
    (rtol 1e-5, atol 1e-6), tri exact except at equal-t ties (the TPU kernel
    orders its walk by a tile-wide octant vote, the port by the ray's own).
  - The plain walk's per-ray visit counts on a hand-built chain.
  - Tests marked `cuda` compare the CUDA kernel with the plain walk on the
    card, exactly: streams of several waves, of 1, 31 and 33 rays,
    all-masked occluded streams and a tree at the stack guard's depth;
    they skip without one.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.accel import bvh as tb
from dpt_tpu_torch.accel.bvh import build_accel
from dpt_tpu_torch.kernels import wide as tw
from dpt_tpu_torch.render.intersect import brute_force_nearest, moller_trumbore
from dpt_tpu_torch.scene.builder import knot_scene
from dpt_tpu_torch.utils.convert import wide_accel_from_arrays
from test_torch_quad import chain_bvh, chain_rays

torch.set_num_threads(2)
CPU = "cpu"
CFG = T.RenderConfig()
N_RAYS = 256

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
    from dpt_tpu.kernels import pallas_wide

    return types.SimpleNamespace(
        jnp=jnp, bvh=bvh, wide=pallas_wide,
        cfg=dpt_tpu.RenderConfig(packet_tile=128, interleave=1))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(kind):
    if kind == "box":
        return T.cornell_box_scene(device=CPU)
    if kind == "sphere":
        return T.procedural_scene(n_tris_target=2_000, device=CPU)
    if kind == "knot":
        return knot_scene(n_tris_target=2_000, device=CPU)
    return T.procedural_scene(n_tris_target=8, device=CPU)


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
    return scene, tw.pack_wide(bvh, *corners, device=CPU)


def _jax_tables(jx, case, scene):
    _, builder, leaf = CASES[case]
    v, idx, corners = _corners(scene)
    build = (jx.bvh.build_bvh_median if builder == "median"
             else jx.bvh.build_bvh_sah)
    return jx.wide.pack_wide(build(v, idx, leaf_size=leaf, use_native=False),
                             *corners)


def _rays(n, seed, spread):
    """Random rays plus axis-aligned ones (zero direction components) and
    two masked lanes (origin 1e9, direction +z, max_dist -1)."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    d[:12] = np.concatenate([axes, axes])
    o[:12] *= 0.1
    d = d.astype(np.float32)
    md = rng.uniform(-0.5, 3.0 * spread, n).astype(np.float32)
    o[-2:] = 1e9
    d[-2:] = [0.0, 0.0, 1.0]
    md[-2:] = -1.0
    return torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(md)


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


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_wide_byte_identical(jx, case):
    scene, acc_t = _port_tables(case)
    acc_j = _jax_tables(jx, case, scene)
    assert acc_t.nodes.numpy().tobytes() == np.asarray(acc_j.nodes).tobytes()
    assert acc_t.tris.numpy().tobytes() == np.asarray(acc_j.tris).tobytes()
    assert (acc_t.n_internal, acc_t.max_depth) == (acc_j.n_internal,
                                                   acc_j.max_depth)
    conv = wide_accel_from_arrays(np.asarray(acc_j.nodes),
                                  np.asarray(acc_j.tris), acc_j.n_internal,
                                  acc_j.max_depth, device=CPU)
    assert torch.equal(conv.nodes, acc_t.nodes)
    assert torch.equal(conv.tris, acc_t.tris)


def test_depth_of_interleaved_ids(jx):
    """Children with smaller ids than their parent (as an LBVH numbers
    them) take the explicit post-order depth walk."""
    scene = T.procedural_scene(n_tris_target=500, device=CPU)
    v, idx, corners = _corners(scene)
    b = tb.build_bvh_median(v, idx, leaf_size=4)
    # Reverse the node ids (root stays 0): every child id drops below its
    # parent's.
    n = b.n_nodes
    new_id = np.concatenate([[0], np.arange(n - 1, 0, -1)])
    old_of = np.argsort(new_id)
    left = b.node_left[old_of].copy()
    right = b.node_right[old_of].copy()
    internal = left >= 0
    left[internal] = new_id[left[internal]]
    right[internal] = new_id[right[internal]]
    fields = dict(node_min=b.node_min[old_of], node_max=b.node_max[old_of],
                  node_left=left, node_right=right, tri_order=b.tri_order)
    acc_t = tw.pack_wide(tb.BVH(**fields), *corners, device=CPU)
    acc_j = jx.wide.pack_wide(jx.bvh.BVH(**fields), *corners)
    assert acc_t.nodes.numpy().tobytes() == np.asarray(acc_j.nodes).tobytes()
    assert acc_t.max_depth == acc_j.max_depth
    # The same tree under other ids: the same depth and the same hits.
    acc_p = tw.pack_wide(b, *corners, device=CPU)
    assert acc_t.max_depth == acc_p.max_depth
    o, d, _ = _rays(128, seed=5, spread=1.5)
    h1, t1, _ = tw.wide_nearest(o, d, acc_t, CFG)
    h2, t2, _ = tw.wide_nearest(o, d, acc_p, CFG)
    assert torch.equal(h1, h2) and torch.equal(t1, t2)


@pytest.fixture(scope="module")
def jax_walk_tables(jx):
    """case -> (scene, port tables, JAX tables).  The JAX tables are padded
    with unreachable zero rows to one common shape, and their static
    n_internal / max_depth (which the kernel does not read) are made
    common, so the interpreted kernel compiles once per mode for all
    cases."""
    out = {c: (*_port_tables(c),) for c in CASES}
    out = {c: (scene, acc_t, _jax_tables(jx, c, scene))
           for c, (scene, acc_t) in out.items()}
    rows_n = max(a.nodes.shape[0] for _, _, a in out.values())
    rows_t = max(a.tris.shape[0] for _, _, a in out.values())

    def pad(x, rows):
        return jx.jnp.pad(x, ((0, rows - x.shape[0]), (0, 0)))

    return {c: (scene, acc_t, dataclasses.replace(
        acc_j, nodes=pad(acc_j.nodes, rows_n), tris=pad(acc_j.tris, rows_t),
        n_internal=8 * rows_n, max_depth=0))
        for c, (scene, acc_t, acc_j) in out.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_walk_matches_jax_kernel(jx, jax_walk_tables, case):
    scene, acc_t, acc_j = jax_walk_tables[case]
    spread = 3.0 if case == "box-median4" else 1.5
    o, d, md = _rays(N_RAYS, seed=len(case) + 40, spread=spread)
    jo, jd, jmd = (jx.jnp.asarray(x.numpy()) for x in (o, d, md))

    jh, jt, ji = (torch.as_tensor(np.array(x)) for x in
                  jx.wide.wide_nearest(jo, jd, acc_j, jx.cfg))
    th, tt, ti = tw.wide_nearest(o, d, acc_t, CFG)
    assert th.dtype == torch.bool and ti.dtype == torch.int32
    assert torch.equal(th, jh)
    assert th.any() and not th.all()
    np.testing.assert_allclose(tt[th].numpy(), jt[th].numpy(), rtol=1e-5,
                               atol=1e-6)
    _check_ties(o, d, scene, tt, ti, ji, th)

    jocc = torch.as_tensor(np.array(
        jx.wide.wide_occluded(jo, jd, jmd, acc_j, jx.cfg)))
    tocc = tw.wide_occluded(o, d, md, acc_t, CFG)
    assert torch.equal(tocc, jocc)
    assert not tocc[md <= 0].any()


def test_plain_walk_matches_brute_force():
    scene, acc = _port_tables("knot-sah8")
    o, d, _ = _rays(2048, seed=22, spread=1.5)
    v0, v1, v2 = scene.tri_vertices()
    bh, bt, bi, _, _ = brute_force_nearest(o, d, v0, v1, v2)
    stats = {}
    wh, wt, wi = tw.wide_nearest_reference(o, d, acc, CFG, stats=stats)
    assert torch.equal(bh, wh)
    np.testing.assert_allclose(wt[bh].numpy(), bt[bh].numpy(), rtol=1e-5,
                               atol=1e-6)
    _check_ties(o, d, scene, wt, wi, bi, bh)
    # Every ray pops the root at least once; leaf tests come in rows of 8.
    assert stats["node_visits"] >= o.shape[0]
    assert stats["tri_tests"] > 0 and stats["tri_tests"] % 8 == 0


def test_masked_lanes_and_empty_stream():
    _, acc = _port_tables("sphere-sah8")
    o = torch.full((5, 3), 1e9)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(5, 1)
    h, t, i = tw.wide_nearest(o, d, acc, CFG)
    assert not h.any() and (t == 1e30).all() and (i == 0).all()
    assert not tw.wide_occluded(o, d, torch.full((5,), -1.0), acc, CFG).any()
    # max_dist <= 0 is never occluded, even for a ray that hits.
    o2 = torch.tensor([[0.0, 0.0, -3.0]])
    d2 = torch.tensor([[0.0, 0.0, 1.0]])
    assert tw.wide_nearest(o2, d2, acc, CFG)[0].all()
    assert tw.wide_occluded(o2, d2, torch.tensor([10.0]), acc, CFG).all()
    assert not tw.wide_occluded(o2, d2, torch.tensor([0.0]), acc, CFG).any()

    e = torch.zeros((0, 3))
    h, t, i = tw.wide_nearest(e, e, acc, CFG)
    assert h.shape == t.shape == i.shape == (0,)
    occ = tw.wide_occluded(e, e, torch.zeros(0), acc, CFG)
    assert occ.shape == (0,) and occ.dtype == torch.bool


def test_stack_guard_and_bad_inputs():
    _, acc = _port_tables("box-median4")
    o, d, md = _rays(16, seed=1, spread=3.0)
    with pytest.raises(ValueError, match="stack_depth"):
        tw.wide_nearest(o, d, acc, CFG.replace(bvh_stack_depth=1))
    with pytest.raises(ValueError, match="stack_depth"):
        tw.wide_occluded(o, d, md, acc, CFG.replace(bvh_stack_depth=1))
    deep = dataclasses.replace(acc, max_depth=63)  # needs 65 > 64 slots
    with pytest.raises(ValueError, match="kernel capacity"):
        tw.wide_nearest(o, d, deep, CFG.replace(bvh_stack_depth=128))
    with pytest.raises(TypeError, match="float32"):
        tw.wide_nearest(o.double(), d, acc, CFG)
    with pytest.raises(ValueError, match="shape"):
        tw.wide_occluded(o, d, md[:4], acc, CFG)
    with pytest.raises(ValueError, match="unsupported device"):
        tw.wide_nearest(o.to("meta"), d.to("meta"), acc.to("meta"), CFG)
    tw.reset_launch_counts()
    tw.wide_nearest(o, d, acc, CFG)
    tw.wide_occluded(o, d, md, acc, CFG)
    assert tw.launch_counts == {"nearest": 0, "occluded": 0}


def test_occluded_agrees_with_nearest():
    """The any-hit query reaches exactly the nearest hit: occluded at
    max_dist = t is false (no hit is strictly nearer), and occluded at the
    next float above t is the nearest query's hit."""
    _, acc = _port_tables("knot-sah8")
    o, d, _ = _rays(256, seed=5, spread=1.5)
    h, t, _ = tw.wide_nearest(o, d, acc, CFG)
    assert h.any() and not h.all()
    assert not tw.wide_occluded(o, d, t, acc, CFG).any()
    above = torch.nextafter(t, torch.full_like(t, float("inf")))
    assert torch.equal(tw.wide_occluded(o, d, above, acc, CFG), h)


def test_pallas_render_matches_quad_and_brute():
    scene = T.procedural_scene(n_tris_target=800, device=CPU)
    cam = T.OrbitCamera(yaw=20.0).camera(CPU)
    cfg = T.preset("sylveon512", width=12, height=12, max_depth=3,
                   traversal="pallas")
    img_w = T.render_sample(scene, cam, cfg, 2, build_accel(scene, cfg))
    cfg_q = cfg.replace(traversal="quad")
    img_q = T.render_sample(scene, cam, cfg_q, 2, build_accel(scene, cfg_q))
    img_b = T.render_sample(scene, cam, cfg.replace(traversal="brute"), 2)
    assert float(img_w.max()) > 0.0
    assert torch.equal(img_w, img_q)
    np.testing.assert_allclose(img_w.numpy(), img_b.numpy(), rtol=1e-4,
                               atol=1e-5)


def _chain_accel(n):
    v, idx, bvh = chain_bvh(n)
    return v, idx, tw.pack_wide(bvh, v[idx[:, 0]], v[idx[:, 1]],
                                v[idx[:, 2]], device=CPU)


def test_plain_walk_counts_visits_per_ray():
    """A ray that misses the root's boxes visits the root record only; a
    ray along -x inside every box that misses every triangle visits every
    internal record; a masked lane visits none; the counts sum to
    node_visits and the results are the walk's without stats."""
    _, _, acc = _chain_accel(3)
    o = torch.tensor([[-1.0, 2.0, 2.0], [6.0, 0.3, 0.3], [-1.0, -0.3, -0.3],
                      [6.0, -0.3, -0.3]])
    d = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                      [-1.0, 0.0, 0.0]])
    md = torch.tensor([10.0, 10.0, -1.0, 10.0])
    for occluded in (False, True):
        stats = {}
        got = tw._walk_reference(o, d, md, acc, occluded, 64, stats=stats)
        want = tw._walk_reference(o, d, md, acc, occluded, 64)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        visits = stats["ray_visits"]
        assert visits.dtype == torch.int64 and visits.shape == (4,)
        assert visits[0] == 1 and visits[1] == acc.n_internal == 6
        assert int(visits.sum()) == stats["node_visits"]
        assert (visits[2] == 0) == occluded


def test_plain_walk_at_stack_guard_depth():
    """The deepest tree the kernel's stack takes (62 + 2 = 64 slots), where
    rays along -x push one record per level, walks like brute force; one
    level deeper is refused."""
    v, idx, acc = _chain_accel(61)
    assert acc.max_depth == 62
    o, d, md = chain_rays(256, 61, seed=4)
    cfg = CFG.replace(bvh_stack_depth=64)
    h, t, i = tw.wide_nearest(o, d, acc, cfg)
    corners = (torch.as_tensor(v[idx[:, k]]) for k in range(3))
    bh, bt, bi, _, _ = brute_force_nearest(o, d, *corners)
    assert torch.equal(h, bh) and h.any() and not h.all()
    assert torch.equal(i, bi)
    np.testing.assert_allclose(t[h].numpy(), bt[h].numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(tw.wide_occluded(o, d, md, acc, cfg),
                       bh & (bt < md) & (md > 0))
    with pytest.raises(ValueError, match="kernel capacity"):
        tw.wide_nearest(o, d, _chain_accel(62)[2],
                        CFG.replace(bvh_stack_depth=128))


def _card_matches_plain(acc, o, d, md, cfg=CFG):
    """K2 on the card equals the plain walk exactly, one launch per
    call."""
    ph, pt, pi = tw.wide_nearest_reference(o, d, acc, cfg)
    po = tw.wide_occluded_reference(o, d, md, acc, cfg)
    tw.reset_launch_counts()
    kh, kt, ki = tw.wide_nearest(o, d, acc, cfg)
    ko = tw.wide_occluded(o, d, md, acc, cfg)
    torch.cuda.synchronize()
    assert tw.launch_counts == {"nearest": 1, "occluded": 1}
    assert torch.equal(kh, ph) and torch.equal(kt, pt)
    assert torch.equal(ki, pi) and torch.equal(ko, po)
    return ph, po


@pytest.mark.cuda
def test_kernel_several_waves_on_card(cuda):
    """A stream of three waves of resident lanes and a ragged end."""
    from dpt_tpu_torch.kernels.build import kernel_attributes

    _, acc = _port_tables("sphere-sah8")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    lanes = max(kernel_attributes("wide_traverse", m)["blocks_per_sm"]
                for m in (False, True)) * 128 * sms
    o, d, md = (x.to(cuda) for x in _rays(3 * lanes + 5, seed=33, spread=1.5))
    kh, ko = _card_matches_plain(acc.to(cuda), o, d, md)
    assert kh.any() and not kh.all() and ko.any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [1, 31, 33])
def test_kernel_small_streams_on_card(cuda, n_rays):
    _, acc = _port_tables("knot-sah8")
    o, d, md = _rays(64, seed=34, spread=1.5)
    o, d, md = (x[16:16 + n_rays].to(cuda) for x in (o, d, md))
    _card_matches_plain(acc.to(cuda), o, d, md)


@pytest.mark.cuda
def test_kernel_all_masked_occluded_on_card(cuda):
    _, acc = _port_tables("sphere-sah8")
    o, d, _ = _rays(5000, seed=35, spread=1.5)
    md = torch.where(torch.arange(5000) % 2 == 0, 0.0, -1.0)
    o, d, md = (x.to(cuda) for x in (o, d, md))
    _, ko = _card_matches_plain(acc.to(cuda), o, d, md)
    assert not ko.any()


@pytest.mark.cuda
def test_kernel_at_stack_guard_depth_on_card(cuda):
    _, _, acc = _chain_accel(61)
    o, d, md = (x.to(cuda) for x in chain_rays(4096, 61, seed=36))
    kh, _ = _card_matches_plain(acc.to(cuda), o, d, md,
                                CFG.replace(bvh_stack_depth=64))
    assert kh.any() and not kh.all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_walk_on_card(cuda, case):
    _, acc = _port_tables(case)
    acc = acc.to(cuda)
    spread = 3.0 if case == "box-median4" else 1.5
    o, d, md = (x.to(cuda) for x in _rays(4096, seed=32, spread=spread))
    tw.reset_launch_counts()
    kh, kt, ki = tw.wide_nearest(o, d, acc, CFG)
    ko = tw.wide_occluded(o, d, md, acc, CFG)
    torch.cuda.synchronize()
    assert tw.launch_counts == {"nearest": 1, "occluded": 1}
    ph, pt, pi = tw.wide_nearest_reference(o, d, acc, CFG)
    po = tw.wide_occluded_reference(o, d, md, acc, CFG)
    assert torch.equal(kh, ph) and torch.equal(kt, pt) and torch.equal(ki, pi)
    assert torch.equal(ko, po)
    assert tw.launch_counts == {"nearest": 1, "occluded": 1}


@pytest.mark.cuda
def test_kernel_masked_empty_and_bad_inputs_on_card(cuda):
    _, acc = _port_tables("sphere-sah8")
    acc = acc.to(cuda)
    o = torch.full((300, 3), 1e9, device=cuda)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=cuda).repeat(300, 1)
    md = torch.full((300,), -1.0, device=cuda)
    tw.reset_launch_counts()
    assert not tw.wide_nearest(o, d, acc, CFG)[0].any()
    assert not tw.wide_occluded(o, d, md, acc, CFG).any()
    e = torch.zeros((0, 3), device=cuda)
    assert tw.wide_nearest(e, e, acc, CFG)[0].shape == (0,)
    assert tw.launch_counts == {"nearest": 1, "occluded": 1}
    with pytest.raises(TypeError):
        tw.wide_nearest(o.double(), d, acc, CFG)
    with pytest.raises(ValueError):
        tw.wide_nearest(o, d, acc.to("cpu"), CFG)
