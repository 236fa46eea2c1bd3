"""The port's native host runtime (utils/native.py, csrc/native_host.cpp)
≡ the port's numpy builders and parser ≡ dpt_tpu's (`use_native=False`),
byte for byte, on the cases of tests/test_native.py: the median and SAH
builds of the procedural sphere, SAH on degenerate centroids, the knot, and
an OBJ file (quads, negative indices, materials); plus a written mesh of a
few thousand triangles, and decimals that a parse straight to float (the
JAX package's native parser) rounds otherwise than Python's float().

The library is built by g++ at first use.  Without g++ on PATH the builders
and the parser fall back to numpy with one line on standard error; a
source that does not compile, or a failing call into the library, raises.
"""

from decimal import Decimal

import numpy as np
import pytest
import torch

import dpt_tpu_torch as T
from dpt_tpu_torch.accel import bvh as B
from dpt_tpu_torch.scene.obj import load_obj, write_obj
from dpt_tpu_torch.utils import native

torch.set_num_threads(2)
FIELDS = ("node_min", "node_max", "node_left", "node_right", "tri_order")
OBJ_FIELDS = ("vertices", "indices", "uvs", "mat_idx", "material_albedo")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from dpt_tpu.accel import bvh
    from dpt_tpu.scene import obj

    return bvh, obj


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("no g++ on PATH")
    return native


def _same(a, b, fields):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def _mesh(kind):
    if kind == "sphere3k":
        s = T.procedural_scene(n_tris_target=3_000, device="cpu")
    elif kind == "sphere5k":
        s = T.procedural_scene(n_tris_target=5_000, device="cpu")
    elif kind == "knot":
        s = T.knot_scene(n_tris_target=4_000, device="cpu")
    else:
        return _degenerate()
    return s.vertices.numpy(), s.indices.numpy()


def _degenerate():
    """tests/test_native.py's fans of triangles sharing one centroid, plus
    two small clusters: the SAH builder's degenerate fallback."""
    rng = np.random.default_rng(7)
    tris = []
    for ci, c in enumerate([(0, 0, 0), (3, 0, 0), (0, 3, 0)]):
        c = np.asarray(c, np.float32)
        for _ in range(48 if ci == 0 else 8):
            th = 2 * np.pi * rng.random()
            r = 0.25 + 0.5 * rng.random()
            pts = np.stack([
                c + r * np.array([np.cos(th + a), np.sin(th + a),
                                  0.3 * np.sin(a)], np.float32)
                for a in (0.0, 2.0943951, 4.1887902)])
            tris.append(pts - pts.mean(axis=0) + c)
    v = np.concatenate(tris).astype(np.float32)
    return v, np.arange(len(v), dtype=np.int32).reshape(-1, 3)


@pytest.mark.parametrize("builder,kind,leaf", [
    ("median", "sphere3k", 4),
    ("sah", "sphere5k", 1),
    ("sah", "sphere5k", 8),
    ("sah", "degenerate", 1),
    ("sah", "degenerate", 4),
    ("sah", "knot", 8),
])
def test_native_tree_is_numpy_tree(jx, lib, builder, kind, leaf):
    v, idx = _mesh(kind)
    name = "build_bvh" if builder == "median" else "build_bvh_sah"
    calls = lib.calls[name]
    got = getattr(lib, f"native_{name}")(v, idx, leaf)
    assert lib.calls[name] == calls + 1
    got = B.BVH(*got)
    port = getattr(B, f"build_bvh_{builder}")(v, idx, leaf_size=leaf,
                                              use_native=False)
    ref = getattr(jx[0], f"build_bvh_{builder}")(v, idx, leaf_size=leaf,
                                                 use_native=False)
    _same(got, port, FIELDS)
    _same(got, ref, FIELDS)


def test_builders_route_as_jax(lib):
    """The native build from 1,024 triangles up (use_native=True, the
    default), numpy below it and with use_native=False; build_accel takes
    the native path."""
    v, idx = _mesh("sphere3k")
    n = dict(lib.calls)
    B.build_bvh_median(v, idx[:1023], leaf_size=4)
    B.build_bvh_sah(v, idx, leaf_size=8, use_native=False)
    assert lib.calls == n
    B.build_bvh_median(v, idx[:1024], leaf_size=4)
    B.build_bvh_sah(v, idx, leaf_size=8)
    scene = T.procedural_scene(n_tris_target=3_000, device="cpu")
    B.build_accel(scene, T.preset("sylveon512", width=8, height=8))
    assert lib.calls == {**n, "build_bvh": n["build_bvh"] + 1,
                         "build_bvh_sah": n["build_bvh_sah"] + 2}


def _fixture_obj(tmp_path):
    (tmp_path / "fixture.mtl").write_text(
        "newmtl red\nKd 0.9 0.1 0.2\nnewmtl blue\nKd 0.1 0.2 0.9\n")
    path = tmp_path / "fixture.obj"
    path.write_text(
        "mtllib fixture.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl red\n"
        "f 1/1 2/2 3/3 4/4\n"       # quad -> fan triangulation
        "usemtl blue\n"
        "f -5/-4 -4/-3 -1/-2\n"      # negative (relative) indices
        "f 1 2 5\n"                  # no texcoords
    )
    return path


def _digits_obj(tmp_path):
    """Decimals just above the midpoint of two float32 values whose lower
    neighbour is even: Python's float() rounds each to the midpoint, which
    float32 then rounds down (to even), while a parse straight to float
    (strtof) rounds up.  Seeded, with 4-gons and texcoords."""
    rng = np.random.default_rng(0)
    lo = rng.uniform(1, 100, size=(3000, 3)).astype(np.float32)
    lo = (lo.view(np.uint32) & np.uint32(0xFFFFFFFE)).view(np.float32)
    mid = (lo.astype(np.float64)
           + np.nextafter(lo, np.float32(np.inf)).astype(np.float64)) / 2
    lines = ["v " + " ".join(f"{Decimal(float(x))}1" for x in p)
             for p in mid]
    lines += ["vt %r %r" % tuple(float(x) for x in p)
              for p in rng.uniform(size=(64, 2))]
    lines += [f"f {i}/{i % 64 + 1} {i + 1}/{(i + 1) % 64 + 1} {i + 2} "
              f"{i + 3}" for i in range(1, 2995, 3)]
    path = tmp_path / "digits.obj"
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("which", ["fixture", "written", "digits"])
def test_native_obj_is_python_obj(jx, lib, tmp_path, which):
    if which == "fixture":
        path = _fixture_obj(tmp_path)
    elif which == "digits":
        path = _digits_obj(tmp_path)
    else:
        s = T.procedural_scene(n_tris_target=3_000, device="cpu")
        path = tmp_path / "sphere.obj"
        write_obj(str(path), s.vertices.numpy(), s.indices.numpy())
    calls = lib.calls["load_obj"]
    got = load_obj(str(path))
    assert lib.calls["load_obj"] == calls + 1
    port = load_obj(str(path), use_native=False)
    ref = jx[1].load_obj(str(path), use_native=False)
    for other in (port, ref):
        _same(got, other, OBJ_FIELDS)
        assert got.material_names == other.material_names


def test_without_gpp_falls_back_to_numpy(monkeypatch, tmp_path, capfd):
    v, idx = _mesh("sphere3k")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    n = dict(native.calls)
    tree = B.build_bvh_sah(v, idx, leaf_size=8)
    mesh = load_obj(str(_fixture_obj(tmp_path)))
    err = capfd.readouterr().err
    assert err.count("no g++ on PATH") == 2, err
    assert native.calls == n and native._LIB is None
    _same(tree, B.build_bvh_sah(v, idx, leaf_size=8, use_native=False),
          FIELDS)
    assert mesh.indices.shape == (4, 3)


def test_native_failures_raise(monkeypatch, tmp_path, lib):
    v, idx = _mesh("sphere3k")
    # A failing call into a working library.
    with pytest.raises(RuntimeError, match="rc=-1"):
        lib.native_build_bvh_sah(v, idx, 0)
    with pytest.raises(RuntimeError, match="native OBJ parse failed"):
        lib.native_load_obj(str(tmp_path / "missing.obj"))
    # A source that does not compile: no quiet fallback.
    broken = tmp_path / "native_host.cpp"
    broken.write_text("int dpt_build_bvh( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        B.build_bvh_sah(v, idx, leaf_size=8)
