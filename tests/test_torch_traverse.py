"""dpt_tpu_torch per-ray BVH walk (accel/traverse.py) for the `bvh`,
`packet` and `threaded` traversals ≡ dpt_tpu's three walks.

The port runs one walk for the three modes, over the tree each mode builds
(`build_accel`); the JAX package runs its own walk for each (per-ray
stacks, one stack per tile, skip-pointer tables).  On the same rays, made
with numpy from a seed, through `make_nearest` / `make_occluded` of each
package: `hit` and `occluded` exact, `t` allclose (rtol 1e-5, atol 1e-6),
and `tri` exact but where the two triangles are hit at an equal t (the
visit order decides a tie).  Renders through each mode equal the brute
force render.  The JAX package's accel of an LBVH case is made from the
port's tree (tests/test_torch_lbvh.py holds the two builders byte for
byte) as JAX `build_accel` makes it from its own, which saves compiling
the JAX builder here.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.accel.bvh import build_accel, host_bvh
from dpt_tpu_torch.accel.lbvh import build_lbvh
from dpt_tpu_torch.render.intersect import moller_trumbore
from dpt_tpu_torch.render.trace import make_nearest, make_occluded

torch.set_num_threads(2)
N_RAYS = 512
# (traversal, builder, leaf size): each JAX walk over a tree of each kind.
CASES = {
    "bvh-median-2": ("bvh", "median", 2),
    "packet-lbvh-4": ("packet", "lbvh", 4),
    "threaded-lbvh-8": ("threaded", "lbvh", 8),
    "threaded-sah-4": ("threaded", "sah", 4),
}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import dpt_tpu
    from dpt_tpu.accel import bvh, threaded
    from dpt_tpu.render import trace

    return types.SimpleNamespace(jnp=jnp, pkg=dpt_tpu, trace=trace, bvh=bvh,
                                 threaded=threaded)


def _jax_accel(jx, js, jcfg, ts):
    """JAX `build_accel`, with the LBVH taken from the port (see the module
    docstring): unpruned for 'packet', pruned into threaded tables for
    'threaded'."""
    if jcfg.bvh_builder != "lbvh":
        return jx.bvh.build_accel(js, jcfg)
    tree = host_bvh(build_lbvh(ts.vertices, ts.indices,
                               leaf_size=jcfg.bvh_leaf_size))
    tree = jx.bvh.BVH(*(jx.jnp.asarray(getattr(tree, f.name))
                        for f in dataclasses.fields(tree)))
    if jcfg.traversal == "threaded":
        return jx.threaded.build_threaded(jx.bvh.prune_bvh(tree),
                                          *js.tri_vertices())
    return tree


def _rays(seed=0):
    """Rays from around and inside the sphere, some through its centre,
    and shadow distances (a few <= 0: masked lanes)."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(N_RAYS, 3)) * 2.0).astype(np.float32)
    aim = rng.normal(size=(N_RAYS, 3)) * 0.3 - o
    aim[: N_RAYS // 8] = rng.normal(size=(N_RAYS // 8, 3))  # outward
    d = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).astype(np.float32)
    md = rng.uniform(-0.5, 4.0, N_RAYS).astype(np.float32)
    return o, d, md


@pytest.fixture(scope="module")
def runs(jx):
    """{case: (port nearest, port occluded, jax nearest, jax occluded,
    port scene)} on the same rays."""
    o, d, md = _rays()
    js = jx.pkg.procedural_scene(n_tris_target=600)
    ts = T.procedural_scene(n_tris_target=600, device="cpu")
    out = {}
    for name, (trav, builder, leaf) in CASES.items():
        kw = dict(traversal=trav, bvh_builder=builder, bvh_leaf_size=leaf)
        jcfg = jx.pkg.RenderConfig(**kw)
        tcfg = T.RenderConfig(**kw)
        ja = _jax_accel(jx, js, jcfg, ts)
        ta = build_accel(ts, tcfg)
        jo, jd, jm = (jx.jnp.asarray(x) for x in (o, d, md))
        jn = jx.trace.make_nearest(js, jcfg, ja)(jo, jd)
        jocc = jx.trace.make_occluded(js, jcfg, ja)(jo, jd, jm)
        to, td, tm = (torch.as_tensor(x) for x in (o, d, md))
        tn = make_nearest(ts, tcfg, ta)(to, td)
        tocc = make_occluded(ts, tcfg, ta)(to, td, tm)
        out[name] = (tn, tocc, {k: np.asarray(v) for k, v in jn.items()},
                     np.asarray(jocc), ts)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_nearest_matches_jax(runs, case):
    tn, _, jn, _, scene = runs[case]
    hit = tn["hit"].numpy()
    np.testing.assert_array_equal(hit, jn["hit"])
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_allclose(np.where(hit, tn["t"].numpy(), 0.0),
                               np.where(hit, jn["t"], 0.0), rtol=1e-5,
                               atol=1e-6)
    tri = tn["tri"].numpy()
    assert tri.dtype == np.int32
    differ = hit & (tri != jn["tri"])
    if differ.any():  # only at equal-t ties
        o, d, _ = (torch.as_tensor(x)[differ] for x in _rays())
        v0, v1, v2 = scene.tri_vertices()

        def t_of(ids):
            ids = torch.as_tensor(ids).long()
            return moller_trumbore(o, d, v0[ids], v1[ids], v2[ids])[1]

        np.testing.assert_allclose(t_of(tri[differ]), t_of(jn["tri"][differ]),
                                   rtol=1e-6)
    assert differ.mean() < 0.02


@pytest.mark.parametrize("case", sorted(CASES))
def test_occluded_matches_jax(runs, case):
    _, tocc, _, jocc, _ = runs[case]
    np.testing.assert_array_equal(tocc.numpy(), jocc)
    assert 0.1 < tocc.numpy().mean() < 0.9


@pytest.mark.parametrize("traversal", ["bvh", "packet", "threaded"])
def test_render_matches_brute(traversal):
    """The box through each mode (median leaf 2) and the sphere (LBVH leaf
    8) render what brute force renders (tests/test_oracle_match.py's
    tolerance)."""
    cam = T.OrbitCamera().camera("cpu")
    for scene, kw in ((T.cornell_box_scene(device="cpu"),
                       dict(bvh_builder="median", bvh_leaf_size=2)),
                      (T.procedural_scene(n_tris_target=600, device="cpu"),
                       dict(bvh_builder="lbvh", bvh_leaf_size=8))):
        cfg = T.RenderConfig(width=12, height=12, max_depth=3, spp=1,
                             traversal=traversal, ray_sort=True, **kw)
        img = T.render_sample(scene, cam, cfg, 1, build_accel(scene, cfg))
        ref = T.render_sample(scene, cam, cfg.replace(traversal="brute"), 1)
        assert float(ref.max()) > 0.0
        np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-3,
                                   atol=2e-3)
