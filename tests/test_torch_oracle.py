"""The port's scalar oracle, scalar shading helpers, validate_bvh and
render_rays ≡ the JAX package's.

The oracle is pure Python in both packages, the same arithmetic in the
same order, so the two images are equal bit for bit; the port's CPU render
is held to it at rtol 1e-3 / atol 2e-3 (tests/test_oracle_match.py:41).
Frames are 8² and smaller: the oracle loops over pixels and triangles.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.accel import bvh as B
from dpt_tpu_torch.accel.lbvh import build_lbvh
from dpt_tpu_torch.oracle.scalar import render_oracle
from dpt_tpu_torch.render import shading
from dpt_tpu_torch.render.renderer import render_rays, render_sample

torch.set_num_threads(2)
RTOL, ATOL = 1e-3, 2e-3
# tests/test_oracle_match.py's full_featured config at 8²: brute, 2 bounces,
# SSS, DoF.
BOX = dict(width=8, height=8, max_depth=2, spp=1, traversal="brute",
           remat_bounces=False)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import dpt_tpu
    from dpt_tpu.accel import bvh
    from dpt_tpu.oracle import scalar
    from dpt_tpu.render import renderer, shading as jshading

    return types.SimpleNamespace(jax=jax, jnp=jnp, pkg=dpt_tpu, bvh=bvh,
                                 scalar=scalar, renderer=renderer,
                                 shading=jshading)


def _moved(pkg, **kw):
    """tests/conftest.py's moved_camera, from either package."""
    return (pkg.OrbitCamera().view_update(120.0, -60.0).zoom_update(0.9)
            .camera(**kw))


@pytest.fixture(scope="module")
def box():
    return T.cornell_box_scene(device="cpu"), _moved(T, device="cpu")


def test_oracle_box_matches_jax_bitwise(jx, box):
    scene, camera = box
    got = render_oracle(scene, camera, T.RenderConfig(**BOX), 0)
    ref = jx.scalar.render_oracle(jx.pkg.cornell_box_scene(), _moved(jx.pkg),
                                  jx.pkg.RenderConfig(**BOX), 0)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)


def test_oracle_procedural_matches_jax_bitwise(jx):
    """A 200-triangle target (224 triangles) of the Sylveon-class sphere,
    4 bounces with SSS, the checker texture and a rough material (every
    scalar helper on the path)."""
    over = dict(width=6, height=6, max_depth=4, spp=1, traversal="brute",
                uv_texture="checker", remat_bounces=False)
    scene = T.procedural_scene(n_tris_target=200, device="cpu")
    scene = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, roughness=torch.full_like(scene.materials.roughness,
                                                   0.5)))
    jscene = jx.pkg.procedural_scene(n_tris_target=200)
    jscene = dataclasses.replace(jscene, materials=dataclasses.replace(
        jscene.materials,
        roughness=jx.jnp.full_like(jscene.materials.roughness, 0.5)))
    got = render_oracle(scene, T.OrbitCamera().camera("cpu"),
                        T.RenderConfig(**over), 3)
    ref = jx.scalar.render_oracle(jscene, jx.pkg.OrbitCamera().camera(),
                                  jx.pkg.RenderConfig(**over), 3)
    assert np.abs(got).max() > 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["box_brute", "sphere_quad"])
def test_render_matches_oracle(box, case):
    """The box by brute force, and a 300-triangle target (224 triangles) of
    the sphere through the flagship recipe (the quad walk's plain version,
    SAH leaf 8, sort, compaction), 4 bounces."""
    if case == "box_brute":
        (scene, camera), cfg, accel = box, T.RenderConfig(**BOX), None
    else:
        scene = T.procedural_scene(n_tris_target=300, device="cpu")
        camera = T.OrbitCamera().camera("cpu")
        cfg = T.preset("sylveon512", width=8, height=8)
        accel = B.build_accel(scene, cfg)
    img = render_sample(scene, camera, cfg, 0, accel).numpy()
    ref = render_oracle(scene, camera, cfg, 0)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(img, ref, rtol=RTOL, atol=ATOL)


def _seeded_inputs(n=64):
    rng = np.random.default_rng(0)
    return [tuple(float(x) for x in row) for row in rng.normal(size=(n, 16))]


@pytest.mark.parametrize("name", ["checker_albedo_s", "oren_nayar_factor_s",
                                  "interpolate_uv_s"])
def test_scalar_helpers_match_jax(jx, name):
    got_fn, ref_fn = getattr(shading, name), getattr(jx.shading, name)
    for r in _seeded_inputs():
        if name == "checker_albedo_s":
            args = (r[:3], r[3:5], 8.0)
        elif name == "oren_nayar_factor_s":
            args = (r[:3], r[3:6], r[6:9], abs(r[9]))
        else:
            args = ((r[:2], r[2:4], r[4:6]), r[6], r[7])
        got, ref = got_fn(*args), ref_fn(*args)
        assert got == ref and not (isinstance(got, float) and math.isnan(got))


@pytest.fixture(scope="module")
def sphere():
    """2,024 triangles: the native builders serve meshes from 1,024."""
    scene = T.procedural_scene(n_tris_target=2_000, device="cpu")
    return scene, scene.vertices.numpy(), scene.indices.numpy()


def _tree(kind, sphere):
    scene, v, idx = sphere
    if kind == "lbvh":
        return build_lbvh(scene.vertices, scene.indices, leaf_size=1)
    if kind == "lbvh_pruned":
        return B.prune_bvh(build_lbvh(scene.vertices, scene.indices,
                                      leaf_size=8))
    build = B.build_bvh_median if kind.endswith("median") else B.build_bvh_sah
    return build(v, idx, leaf_size=8, use_native=kind.startswith("native"))


@pytest.mark.parametrize("kind", ["median", "sah", "native_median",
                                  "native_sah", "lbvh", "lbvh_pruned"])
def test_validate_bvh_accepts_port_trees(sphere, kind):
    B.validate_bvh(_tree(kind, sphere), sphere[1], sphere[2])


def _faulty(fault, bvh):
    bvh = B.host_bvh(bvh)
    if fault == "duplicate_tri":
        order = bvh.tri_order.copy()
        order[1] = order[0]
        return dataclasses.replace(bvh, tri_order=order)
    left = bvh.node_left
    child = int(left[np.nonzero(left >= 0)[0][0]])
    nmax = bvh.node_max.copy()
    nmax[child] += 1.0
    return dataclasses.replace(bvh, node_max=nmax)


@pytest.mark.parametrize("fault", ["duplicate_tri", "child_outside_parent"])
def test_validate_bvh_raises_where_jax_does(jx, sphere, fault):
    bad = _faulty(fault, _tree("sah", sphere))
    with pytest.raises(AssertionError):
        jx.bvh.validate_bvh(jx.bvh.BVH(*dataclasses.astuple(bad)), sphere[1],
                            sphere[2])
    with pytest.raises(AssertionError):
        B.validate_bvh(bad, sphere[1], sphere[2])


def test_render_rays_matches_jax(jx, box):
    scene, camera = box
    cfg = T.RenderConfig(**BOX)
    px = torch.tensor([0, 3, 7, 5, 2], dtype=torch.int64)
    py = torch.tensor([0, 1, 7, 4, 6], dtype=torch.int64)
    got = render_rays(scene, camera, cfg, 5, pixels=(px, py)).numpy()
    ref = np.asarray(jx.jax.jit(jx.renderer.render_rays,
                                static_argnames=("cfg",))(
        jx.pkg.cornell_box_scene(), _moved(jx.pkg), jx.pkg.RenderConfig(**BOX),
        jx.jnp.uint32(5), px=jx.jnp.asarray(px.numpy(), jx.jnp.int32),
        py=jx.jnp.asarray(py.numpy(), jx.jnp.int32)))
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    full = render_rays(scene, camera, cfg, 5).numpy()
    np.testing.assert_array_equal(
        full.reshape(8, 8, 3)[py.numpy(), px.numpy()], got)
