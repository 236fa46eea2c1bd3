"""The plain reference against the port's plain path at 16x16 on the CPU,
through whole runs of each mix, and the reference's hit queries against
a brute-force search."""

import time

import pytest
import torch

from benchmark import core, scenes
from benchmark.reference.accel import Tree
from conftest import SMALL

CELLS = ["knot2048.converge", "knot2048.invert", "sylveon2048.interactive"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(cell):
    c = core.Cell(cell)
    line, notes, detail = core.run_cell(c, 2 ** 31 + 7, 1.0, False,
                                        torch.device("cpu"),
                                        time.perf_counter(), SMALL)
    assert line["correct"], (line, detail)
    assert line["attempted"] >= 1
    for name, v in line["check"].items():
        assert v["value"] <= 1e-5, (name, v, detail)
    assert [n.split()[1] for n in notes[-len(c.limits):]] == list(c.limits)


def _brute(tree, o, d):
    n = tree.v0.shape[0]
    R = o.shape[0]
    ray = torch.arange(R).repeat_interleave(n)
    leafless = tree._tests
    tri = torch.arange(n).repeat(R)
    # Test every (ray, triangle) pair in the tree's own arithmetic.
    tree_leaf = tree.leaf_tris
    tree.leaf_tris = tri.view(-1, 1).expand(-1, 4).clone()
    tree.leaf_tris[:, 1:] = -1
    try:
        r, t_id, hit, t = leafless(o, d, ray, torch.arange(R * n))
    finally:
        tree.leaf_tris = tree_leaf
    return r, t_id, hit, t


@pytest.mark.parametrize("family", ["bumpy_sphere", "torus_knot"])
def test_tree_queries_equal_brute_force(family):
    v, i = scenes.mesh({"family": family, "n_tris_target": 600})
    tree = Tree(torch.as_tensor(v), torch.as_tensor(i))
    g = torch.Generator().manual_seed(3)
    o = torch.randn(300, 3, generator=g) * 1.5
    d = torch.nn.functional.normalize(torch.randn(300, 3, generator=g),
                                      dim=1)
    active = torch.rand(300, generator=g) > 0.1
    hit, t, tri = tree.nearest(o, d, active)
    r, t_id, h, tt = _brute(tree, o, d)
    for k in range(300):
        sel = (r == k) & h
        if not active[k] or not sel.any():
            assert not hit[k]
            continue
        tk, ik = tt[sel], t_id[sel]
        best = tk.min()
        assert hit[k] and t[k] == best
        assert tri[k] == ik[tk == best].min()
    md = torch.rand(300, generator=g) * 3.0
    occ = tree.occluded(o, d, md, active)
    for k in range(300):
        sel = (r == k) & h & (tt < md[k])
        assert bool(occ[k]) == bool(active[k] and sel.any())


def test_window_step_is_checked_apart_from_the_setup_steps():
    """The optimisation's last window step is repeated from the program's
    state before it: moving that state moves the last step's numbers
    alone, and the set-up steps' numbers stay as they were."""
    cpu = torch.device("cpu")
    c = core.Cell("knot2048.invert")
    inputs, outputs, *_ = core.measure(c, 99, 1.0, False, cpu, SMALL)
    base, _ = core.judge(c, inputs, outputs, 99, cpu)
    last = dict(outputs["last"], albedo=outputs["last"]["albedo"] + 0.05)
    moved, _ = core.judge(c, inputs, dict(outputs, last=last), 99, cpu)
    setup = ("loss_gap", "grad_gap", "step_gap")
    assert {k: moved[k] for k in setup} == {k: base[k] for k in setup}
    assert not core.over_limits(c, base), base
    assert set(core.over_limits(c, moved)) >= {"last_loss_gap"}, moved
