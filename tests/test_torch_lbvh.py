"""dpt_tpu_torch LBVH (accel/lbvh.py) and prune_bvh ≡ dpt_tpu, byte for
byte.

The tree the port builds with torch ops, the pruned tree and its 4-wide
pack equal the JAX package's `build_lbvh` (jitted), `prune_bvh` and
`pack_quad` exactly, array by array and dtype by dtype, on the shapes of
tests/test_lbvh.py (the procedural sphere of 1,500 triangles) at leaf
sizes 1, 2 and 8; `build_accel` prunes the tree for the packed walks
only, as the JAX package does.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.accel import bvh as tb
from dpt_tpu_torch.accel.lbvh import build_lbvh, morton3d
from dpt_tpu_torch.kernels.quad import pack_quad
from dpt_tpu_torch.kernels.wide import pack_wide

torch.set_num_threads(2)
FIELDS = [f.name for f in dataclasses.fields(tb.BVH)]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import dpt_tpu
    from dpt_tpu.accel import bvh, lbvh
    from dpt_tpu.kernels import pallas_quad

    return types.SimpleNamespace(
        jnp=jnp, pkg=dpt_tpu, bvh=bvh, lbvh=lbvh, quad=pallas_quad,
        build=jax.jit(lbvh.build_lbvh, static_argnames=("leaf_size",)))


@pytest.fixture(scope="module")
def meshes(jx):
    """(JAX scene, the port's copy of its arrays): tests/test_lbvh.py's
    sphere.  (Each leaf size is one JAX compile of the builder.)"""
    js = jx.pkg.procedural_scene(n_tris_target=1500)
    return js, (torch.as_tensor(np.array(js.vertices)),
                torch.as_tensor(np.array(js.indices)))


def _same(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), getattr(b, f)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_morton_codes_exact(jx):
    q = np.random.default_rng(0).integers(0, 1024, (4096, 3))
    q[:4] = [[0, 0, 0], [1023, 1023, 1023], [1, 0, 0], [0, 0, 1]]
    ref = np.asarray(jx.lbvh.morton3d(jx.jnp.asarray(q, jx.jnp.uint32)))
    np.testing.assert_array_equal(
        morton3d(torch.as_tensor(q)).numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("leaf_size", [1, 2, 8])
def test_lbvh_and_prune_byte_identical(jx, meshes, leaf_size):
    js, (v, idx) = meshes
    ref = jx.build(js.vertices, js.indices, leaf_size=leaf_size)
    got = build_lbvh(v, idx, leaf_size=leaf_size)
    _same(ref, got)
    _same(jx.bvh.prune_bvh(ref), tb.prune_bvh(got))


@pytest.mark.parametrize("leaf_size", [2, 8])
def test_pack_quad_of_lbvh_byte_identical(jx, meshes, leaf_size):
    js, (v, idx) = meshes
    ref = jx.bvh.prune_bvh(jx.build(js.vertices, js.indices,
                                    leaf_size=leaf_size))
    vn, ixn = np.asarray(js.vertices), np.asarray(js.indices)
    corners = (vn[ixn[:, 0]], vn[ixn[:, 1]], vn[ixn[:, 2]])
    jq = jx.quad.pack_quad(ref, *corners)
    tq = pack_quad(tb.prune_bvh(build_lbvh(v, idx, leaf_size=leaf_size)),
                   *corners, device="cpu")
    np.testing.assert_array_equal(tq.nodes_flat.numpy(),
                                  np.asarray(jq.nodes_flat))
    np.testing.assert_array_equal(tq.tris.numpy(), np.asarray(jq.tris))
    assert (tq.n_wide, tq.max_depth) == (jq.n_wide, jq.max_depth)


def test_single_triangle():
    v = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    bvh = build_lbvh(v, torch.tensor([[0, 1, 2]]))
    assert bvh.n_nodes == 1 and int(bvh.node_left[0]) == -1


@pytest.mark.parametrize("traversal,pruned", [
    ("quad", True), ("pallas", True), ("threaded", True), ("bvh", False),
    ("packet", False),
])
def test_build_accel_prunes_for_packed_walks(traversal, pruned):
    scene = T.procedural_scene(n_tris_target=600, device="cpu")
    cfg = T.RenderConfig(traversal=traversal, bvh_builder="lbvh",
                         bvh_leaf_size=4)
    acc = tb.build_accel(scene, cfg)
    full = build_lbvh(scene.vertices, scene.indices, leaf_size=4)
    want = tb.host_bvh(tb.prune_bvh(full) if pruned else full)
    if traversal in ("bvh", "packet", "threaded"):
        _same(want, acc)
        assert all(isinstance(getattr(acc, f), torch.Tensor) for f in FIELDS)
    else:
        v = scene.vertices.numpy()
        idx = scene.indices.numpy()
        corners = (v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]])
        pack = pack_quad if traversal == "quad" else pack_wide
        ref = pack(want, *corners, device="cpu")
        np.testing.assert_array_equal(acc.tris.numpy(), ref.tris.numpy())
    # Every tree renders what brute force renders.
    cam = T.OrbitCamera().camera("cpu")
    small = cfg.replace(width=8, height=8, max_depth=2, enable_sss=False)
    np.testing.assert_allclose(
        T.render_sample(scene, cam, small, 0, acc).numpy(),
        T.render_sample(scene, cam, small.replace(traversal="brute"),
                        0).numpy(), rtol=1e-4, atol=1e-5)
