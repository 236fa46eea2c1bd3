"""dpt_tpu_torch config, scenes, camera and state conversion ≡ dpt_tpu.

Inputs go through both packages; JAX runs on the CPU (tests/conftest.py).
Tests that need the JAX package take the `jx` fixture, so this file still
runs where JAX is missing.
"""

import dataclasses
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.scene.builder import knot_scene as t_knot_scene
from dpt_tpu_torch.utils.convert import (
    camera_from_arrays,
    quad_accel_from_arrays,
    scene_from_arrays,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import dpt_tpu
    from dpt_tpu.scene import builder

    return types.SimpleNamespace(pkg=dpt_tpu, builder=builder)


def _scene_arrays(scene):
    """The 13 arrays of a Scene (either package) as numpy, in the order
    scene_from_arrays takes them."""
    m, lt = scene.materials, scene.lights
    return [np.asarray(x) for x in (
        scene.vertices, scene.indices, scene.uvs, scene.mat_idx,
        m.albedo, m.roughness, m.emission, m.sss_albedo, m.sss_radius,
        lt.position, lt.normal, lt.intensity, lt.size)]


def _tensor_arrays(scene):
    m, lt = scene.materials, scene.lights
    return [x.numpy() for x in (
        scene.vertices, scene.indices, scene.uvs, scene.mat_idx,
        m.albedo, m.roughness, m.emission, m.sss_albedo, m.sss_radius,
        lt.position, lt.normal, lt.intensity, lt.size)]


def test_config_defaults_equal(jx):
    assert dataclasses.asdict(T.RenderConfig()) == dataclasses.asdict(
        jx.pkg.RenderConfig())
    assert [f.name for f in dataclasses.fields(T.RenderConfig)] == [
        f.name for f in dataclasses.fields(jx.pkg.RenderConfig)]


@pytest.mark.parametrize("name", sorted(T.PRESETS))
def test_presets_equal(jx, name):
    assert dataclasses.asdict(T.PRESETS[name]) == dataclasses.asdict(
        jx.pkg.PRESETS[name])


@pytest.mark.parametrize("over", [
    ({"traversal": "bvh"}, None, None),
    ({"traversal": "packet"}, None, None),
    ({"traversal": "threaded"}, None, None),
    ({"wavefront_sort": True}, None, None),
    ({"kernels": "pallas"}, ValueError, "'none' or 'intersect'"),
])
def test_unported_options_raise(over):
    """Every option of the JAX config is ported now: the traversals and the
    wavefront sort construct; a kernels value that is no kernel path is
    still refused (kernels="intersect" is ported)."""
    fields, exc, match = over
    if exc is None:
        cfg = T.RenderConfig(**fields)
        assert all(getattr(cfg, k) == v for k, v in fields.items())
    else:
        with pytest.raises(exc, match=match):
            T.RenderConfig(**fields)
    assert T.RenderConfig(kernels="intersect").kernels == "intersect"


@pytest.mark.parametrize("which", ["box", "sphere", "knot"])
def test_scene_arrays_identical(jx, which):
    if which == "box":
        j = jx.builder.cornell_box_scene()
        t = T.cornell_box_scene(device="cpu")
    elif which == "sphere":
        j = jx.builder.procedural_scene(n_tris_target=2_000)
        t = T.procedural_scene(n_tris_target=2_000, device="cpu")
    else:
        j = jx.builder.knot_scene(n_tris_target=2_000)
        t = t_knot_scene(n_tris_target=2_000, device="cpu")
    for a, b in zip(_scene_arrays(j), _tensor_arrays(t)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("moves", [
    [], [("view", 120.0, -60.0), ("zoom", 0.9)],
    [("view", 30.0, 400.0), ("view", -10.0, 5.0), ("zoom", 1.1)],
])
def test_camera_matches(jx, moves):
    j, t = jx.pkg.OrbitCamera(), T.OrbitCamera()
    for m in moves:
        if m[0] == "view":
            j, t = j.view_update(m[1], m[2]), t.view_update(m[1], m[2])
        else:
            j, t = j.zoom_update(m[1]), t.zoom_update(m[1])
    assert j.state_tuple() == t.state_tuple()
    assert j._correction == t._correction
    jc, tc = j.camera(), t.camera("cpu")
    for f in ("position", "direction", "up", "fov_deg"):
        got = getattr(tc, f)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jc, f)),
                                   rtol=1e-6)


def test_convert_round_trips(jx):
    from dpt_tpu.accel.bvh import build_accel as j_build_accel

    j = jx.builder.procedural_scene(n_tris_target=1_000)
    t = scene_from_arrays(*_scene_arrays(j), device="cpu")
    for a, b in zip(_scene_arrays(j), _tensor_arrays(t)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    jc = jx.pkg.OrbitCamera().view_update(40.0, 10.0).camera()
    tc = camera_from_arrays(*(np.asarray(getattr(jc, f)) for f in
                              ("position", "direction", "up", "fov_deg")),
                            device="cpu")
    assert tc.fov_deg.shape == ()
    for f in ("position", "direction", "up", "fov_deg"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))

    cfg = jx.pkg.RenderConfig(traversal="quad", bvh_builder="sah",
                              bvh_leaf_size=8)
    ja = j_build_accel(j, cfg)
    ta = quad_accel_from_arrays(np.asarray(ja.nodes_flat),
                                np.asarray(ja.tris), ja.n_wide, ja.max_depth,
                                device="cpu")
    np.testing.assert_array_equal(ta.nodes_flat.numpy(),
                                  np.asarray(ja.nodes_flat))
    np.testing.assert_array_equal(ta.tris.numpy(), np.asarray(ja.tris))
    assert (ta.n_wide, ta.max_depth) == (ja.n_wide, ja.max_depth)
    with pytest.raises(ValueError):
        quad_accel_from_arrays(np.zeros(31, np.float32),
                               np.zeros((1, 128), np.float32), 1, 1,
                               device="cpu")


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import dpt_tpu_torch, dpt_tpu_torch.cli, dpt_tpu_torch.utils.convert\n"
        "import dpt_tpu_torch.kernels.build, dpt_tpu_torch.render.integrator\n"
        "import dpt_tpu_torch.kernels.wide, dpt_tpu_torch.diff.grads\n"
        "import dpt_tpu_torch.diff.optimize, dpt_tpu_torch.utils.checkpoint\n"
        "import dpt_tpu_torch.kernels.intersect, dpt_tpu_torch.scene.obj\n"
        "import dpt_tpu_torch.utils.native as N, dpt_tpu_torch.accel.bvh\n"
        "import numpy as np\n"
        "v = np.random.default_rng(0).normal(size=(3072, 3))\n"
        "dpt_tpu_torch.accel.bvh.build_bvh_sah(\n"
        "    v, np.arange(3072, dtype=np.int32).reshape(-1, 3))\n"
        "assert N.calls['build_bvh_sah'] == int(N.available())\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libdpt_native.so' not in maps, 'the JAX runtime is loaded'\n"
        "assert not [m for m in sys.modules if '.probes' in m], 'probes'\n"
        "import dpt_tpu_torch.probes.r3_smem_proto\n"
        "import dpt_tpu_torch.probes.probe_interleave\n"
        "import dpt_tpu_torch.probes.probe_interleave_any\n"
        "import dpt_tpu_torch.probes.probe_interleave2\n"
        "import dpt_tpu_torch.probes.probe_gather\n"
        "import dpt_tpu_torch.probes.probe_crossbar\n"
        "import dpt_tpu_torch.probes.probe_pallas\n"
        "import dpt_tpu_torch.probes.probe_pallas2\n"
        "import dpt_tpu_torch.bench, dpt_tpu_torch.oracle.scalar\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'dpt_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _float_tensors(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            if v.is_floating_point():
                yield prefix + f.name, v
        elif dataclasses.is_dataclass(v):
            yield from _float_tensors(v, prefix + f.name + ".")


def test_every_float_tensor_is_float32():
    from dpt_tpu_torch.accel.bvh import build_accel
    from dpt_tpu_torch.render.raygen import generate_rays

    scene = T.procedural_scene(n_tris_target=500, device="cpu")
    cam = T.OrbitCamera(yaw=10.0, pitch=5.0).camera("cpu")
    cfg = T.RenderConfig(width=4, height=4, traversal="quad",
                         bvh_builder="sah", bvh_leaf_size=8)
    accel = build_accel(scene, cfg)
    found = list(_float_tensors(scene)) + list(_float_tensors(cam)) + list(
        _float_tensors(accel))
    assert len(found) == 17
    for name, v in found:
        assert v.dtype == torch.float32, name
    o, d, st = generate_rays(cam, cfg, 0)
    assert o.dtype == d.dtype == torch.float32 and st.dtype == torch.int64
    with pytest.raises(TypeError, match="float32"):
        dataclasses.replace(scene, vertices=scene.vertices.double())
    with pytest.raises(TypeError, match="int32"):
        dataclasses.replace(scene, indices=scene.indices.long())


def _all_tensors(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield prefix + f.name, v
        elif dataclasses.is_dataclass(v):
            yield from _all_tensors(v, prefix + f.name + ".")


def test_to_device_moves_every_tensor():
    scene = T.cornell_box_scene(device="cpu")
    cam = T.OrbitCamera().camera("cpu")
    for obj in (scene, cam):
        moved = obj.to("meta")
        names = [n for n, _ in _all_tensors(obj)]
        got = dict(_all_tensors(moved))
        assert sorted(got) == sorted(names) and len(names) >= 4
        for name, v in got.items():
            assert v.device.type == "meta", name
        # The original stays where it was.
        assert all(v.device.type == "cpu" for _, v in _all_tensors(obj))
    assert scene.to("meta").lights.count == 1
    assert scene.to("meta").device.type == "meta"


@pytest.mark.parametrize("make", [
    lambda: T.cornell_box_scene(),
    lambda: T.procedural_scene(n_tris_target=100),
    lambda: t_knot_scene(n_tris_target=100),
    lambda: T.default_lights(),
    lambda: T.make_area_lights([[0, 1, 0]], [[0, -1, 0]], [[1, 1, 1]],
                               [[1, 1]]),
    lambda: T.Materials.default(),
    lambda: T.OrbitCamera().camera(),
], ids=["box", "sphere", "knot", "lights", "area_lights", "materials",
        "camera"])
def test_builders_default_to_the_card(make):
    """Library entry points run on the card unless asked for the CPU; with
    no card they raise with the CLI's message instead of falling back."""
    if torch.cuda.is_available():
        assert all(v.is_cuda for _, v in _all_tensors(make()))
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        make()
