"""The port's bench (`python -m dpt_tpu_torch.bench`) ≡ the root bench.py.

The recipe, the flags and the accounting are held against the JAX file:
its `_flagship_cfg` through importlib, its flags from its syntax tree (it
builds its parser inside `main`), its accounting through the JAX package's
utils/metrics.py.  The runs here are on the CPU at 16² or smaller, with the
live-fraction diagnostic cut from 256² to 16²; the card runs the full
width (chip_smoke.py phase 22).
"""

import ast
import dataclasses
import importlib.util
import json
import pathlib

import pytest
import torch

from dpt_tpu_torch import bench

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "vs_baseline", "step_ms", "rays_per_s_net",
        "live_in_by_depth", "live_in_res", "kernel_mode", "table_modes",
        "config"}


def _jax_flags():
    """bench.py's `add_argument` calls: flag -> its keyword arguments that
    parsing depends on (default, type, choices, action)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            action = (ast.literal_eval(kw["action"]) if "action" in kw
                      else None)
            flags[node.args[0].value] = {
                "default": (ast.literal_eval(kw["default"]) if "default" in kw
                            else False if action == "store_true" else None),
                "type": kw["type"].id if "type" in kw else None,
                "choices": (ast.literal_eval(kw["choices"])
                            if "choices" in kw else None),
                "action": action,
            }
    return flags


JAX_FLAGS = _jax_flags()


@pytest.fixture(scope="module")
def jbench():
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jmetrics():
    pytest.importorskip("jax")
    from dpt_tpu.utils import metrics

    return metrics


def test_flagship_cfg_matches_jax(jbench):
    got = dataclasses.asdict(bench._flagship_cfg(1024, 4))
    ref = dataclasses.asdict(jbench._flagship_cfg(1024, 4))
    shared = set(got) & set(ref)
    assert len(shared) >= 30
    assert {k: got[k] for k in shared} == {k: ref[k] for k in shared}


def test_parser_adds_only_device():
    actions = bench._build_parser()._option_string_actions
    assert set(actions) - set(JAX_FLAGS) == {"-h", "--help", "--device"}
    assert actions["--device"].default == "cuda"


@pytest.mark.parametrize("flag", sorted(JAX_FLAGS))
def test_flag_matches_jax(flag):
    """Each of bench.py's flags parses, with its default, type, choices and
    action."""
    ref = JAX_FLAGS[flag]
    action = bench._build_parser()._option_string_actions[flag]
    assert action.default == ref["default"]
    assert action.choices == ref["choices"]
    assert (action.type.__name__ if action.type else None) == ref["type"]
    if ref["action"] == "store_true":
        assert action.const is True and action.nargs == 0
    else:
        assert action.nargs is None
        value = (ref["choices"][-1] if ref["choices"]
                 else {"int": "7", "float": "0.25"}[ref["type"]])
        args = bench._build_parser().parse_args([flag, value])
        got = getattr(args, action.dest)
        assert got == (float(value) if ref["type"] == "float"
                       else int(value) if ref["type"] == "int" else value)


def _run(monkeypatch, capsys, argv):
    """main(argv) on the CPU with the live fractions at 16²: its one JSON
    line."""
    monkeypatch.setattr(bench, "LIVE_IN_RES", 16)
    bench.main(["--device", "cpu", "--tris", "300", "--iters", "1", *argv])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_cpu_run_prints_jax_line(monkeypatch, capsys, jmetrics):
    out = _run(monkeypatch, capsys, ["--width", "16"])
    assert set(out) == KEYS
    cfg = bench._flagship_cfg(16, 1)
    gross = 16 * 16 * jmetrics.traversals_per_sample(cfg, 1)
    step_s = out["step_ms"] / 1e3
    # value and step_ms are rounded to 0.1 rays/s and 0.01 ms.
    assert out["value"] == pytest.approx(gross / step_s,
                                         rel=0.006 / out["step_ms"], abs=0.1)
    # The net count from the printed (4-decimal) live fractions: each of
    # the 8 traversals of 4 bounces moves by at most 5e-5.
    live = out["live_in_by_depth"]
    assert len(live) == 4 and live[0] == 1.0
    net = 16 * 16 * jmetrics.effective_traversals_per_sample(cfg, 1, live)
    assert out["rays_per_s_net"] / out["value"] == pytest.approx(
        net / gross, abs=4 * 8 * 5e-5 * 256 / gross + 1e-6)
    assert out["metric"] == ("rays/sec/chip fwd (gross) 16x16 4bounce "
                             "224tris")
    assert out["unit"] == "rays/s" and out["live_in_res"] == 16
    assert out["kernel_mode"] == "PLAIN-CPU"
    assert out["table_modes"] == "plain"
    assert out["vs_baseline"] is None
    assert out["config"].startswith("quad+sah8+ray_sort tile=4096 "
                                    "preshade-compact=")


@pytest.mark.parametrize("argv,tail", [
    (["--grad"], " bwd=tape"),
    (["--grad", "--grad-replay"], " bwd=replay"),
])
def test_grad_config(monkeypatch, capsys, argv, tail):
    out = _run(monkeypatch, capsys, ["--width", "8", *argv])
    assert out["config"].endswith(tail)
    assert out["metric"].startswith("rays/sec/chip fwd+bwd (gross) 8x8 ")
    assert out["value"] > 0 and out["step_ms"] > 0


def test_default_device_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main(["--width", "8", "--tris", "300", "--iters", "1"])
    assert capsys.readouterr().out == ""
