"""BENCHMARK.json against the contract's rules of form, and every piece
found by name."""

import json
import re
import subprocess
import sys

import pytest

from benchmark import core

BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_text():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert TEXT.match(w["why"]) and w["chips"] == 1
    for c in BENCH["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for m in BENCH["per_layer"]:
        assert TEXT.match(m["layer"])


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = core.Cell(cell, BENCH)
    assert c.config["name"] == c.spec["config"]
    assert c.config["reduced"] == []
    assert c.mix["loop"] in ("progressive", "optimize")
    assert any(m["name"] != "setup_s" for m in c.end_to_end)
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(core.reader(m["name"])), m["name"]


def test_metrics_have_readers_and_no_more():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.name[:-3] for p in (core.HERE / "metrics").glob("*.py")}
    assert names == files


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT,
                         capture_output=True, text=True, check=True).stdout
    return set(out.split())


_PRINT = ("import sys; print(' '.join(sorted({m.split('.')[0] "
          "for m in sys.modules})))")


def test_harness_loads_no_jax():
    tops = _loaded(
        "import sys; sys.path.insert(0, '.'); "
        "import benchmark.core, benchmark.drive, benchmark.trace; "
        "import benchmark.reference.check; "
        "import dpt_tpu_torch.render.renderer, dpt_tpu_torch.diff.grads, "
        "dpt_tpu_torch.diff.optimize, dpt_tpu_torch.accel.bvh, "
        "dpt_tpu_torch.scene.builder, dpt_tpu_torch.scene.camera; "
        + _PRINT)
    assert not tops & set(core.FORBIDDEN)
    assert "dpt_tpu_torch" in tops


def test_reference_loads_nothing_of_the_program():
    tops = _loaded(
        "import sys; sys.path.insert(0, '.'); import torch; "
        "from benchmark.reference import check, tracer; "
        "from benchmark import scenes; "
        "v, i = scenes.mesh({'family': 'bumpy_sphere', "
        "'n_tris_target': 300}); "
        "s = check.reference_scene({'vertices': v, 'indices': i, "
        "'material': {'albedo': [.8] * 3, 'roughness': 0., "
        "'emission': [0.] * 3, 'sss_albedo': [1., .2, .1], "
        "'sss_radius': 1.}, 'lights': [([0, 2, 0], [0, -1, 0], "
        "[10] * 3, [2.5, 2.5])], 'settings': {'width': 8, 'height': 8, "
        "'max_depth': 2, 'sss_bounces': 1, 'enable_sss': True, "
        "'enable_dof': True, 'aperture': .02, 'focal_distance': 3., "
        "'aa_jitter': .5, 'offset': 1e-3, 'eps': 1e-6}}, 'cpu'); "
        "cam = scenes.orbit(0., 0., 5., 60.); "
        "s.render(cam, 7, torch.arange(8)); "
        + _PRINT)
    assert not tops & {"jax", "jaxlib", "flax", "dpt_tpu", "dpt_tpu_torch"}
