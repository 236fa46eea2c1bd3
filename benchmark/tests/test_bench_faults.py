"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have: a step that returns its state unchanged,
half of the batch left out (the mean taken over the rest), and an answer
altered where it is produced.  (No cell spans chips, so none can leave
out an exchange between them.)  Each fault is planted from the first
step on, and in the optimisation cell also from the window's first step
on alone, past the steps that set-up checks.  On the CPU at 16x16 here;
the card test reads the window's faults at the cell's own size."""

import contextlib
import time

import pytest
import torch

from benchmark import core
from conftest import SMALL


@contextlib.contextmanager
def planted(fault, loop, skip=0):
    """Break the program under the harness for the length of the block,
    from its (skip + 1)-th call on."""
    from dpt_tpu_torch.diff import grads, optimize
    from dpt_tpu_torch.render import renderer

    saved = []

    def put(mod, name, value):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def late(good, bad):
        calls = [0]

        def either(*a, **k):
            calls[0] += 1
            return (bad if calls[0] > skip else good)(*a, **k)
        return either

    if loop == "progressive":
        render = renderer.render_sample
        if fault == "unchanged":
            put(renderer, "accumulate", late(
                renderer.accumulate, lambda prev, new, b, cfg: prev))
        elif fault == "half":
            def half(*a, **k):
                img = render(*a, **k)
                return img[0::2].repeat_interleave(2, dim=0)[:img.shape[0]]
            put(renderer, "render_sample", late(render, half))
        elif fault == "altered":
            put(renderer, "render_sample",
                late(render, lambda *a, **k: render(*a, **k) * 1.01))
    else:
        lg = grads.tape_loss_and_grads
        if fault == "unchanged":
            make = optimize.make_optimizer

            def frozen(name, lr, ts):
                # Adam at a rate of 0 keeps its moments and leaves the
                # albedo where it stands.
                opt = make(name, lr, ts)
                step = opt.step

                def at_rate_0(*a, **k):
                    for group in opt.param_groups:
                        group["lr"] = 0.0
                    return step(*a, **k)
                opt.step = late(step, at_rate_0)
                return opt
            put(optimize, "make_optimizer", frozen)
        elif fault == "half":
            def half(scene, camera, cfg, target, **k):
                H, W = cfg.height, cfg.width
                rows = torch.arange(H // 2, device=target.device)
                py = rows.repeat_interleave(W)
                px = torch.arange(W, device=target.device).repeat(H // 2)
                loss, g = lg(scene, camera, cfg, target[:H // 2],
                             pixels=(px, py), **k)
                return loss * 2.0, {n: x * 2.0 for n, x in g.items()}
            put(grads, "tape_loss_and_grads", late(lg, half))
        elif fault == "altered":
            def altered(*a, **k):
                loss, g = lg(*a, **k)
                return loss, {n: x * 1.05 for n, x in g.items()}
            put(grads, "tape_loss_and_grads", late(lg, altered))
    try:
        yield
    finally:
        for mod, name, value in reversed(saved):
            setattr(mod, name, value)


def faulty_run(cell, fault, seed, device, overrides, seconds=1.0,
               in_window=False):
    c = core.Cell(cell)
    skip = c.mix["warmup_units"] if in_window else 0
    with planted(fault, c.mix["loop"], skip):
        line, _, detail = core.run_cell(c, seed, seconds, False, device,
                                        time.perf_counter(), overrides)
    return line, detail


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["knot2048.converge", "knot2048.invert",
                                  "sylveon2048.interactive"])
def test_fault_is_not_correct(cell, fault):
    line, detail = faulty_run(cell, fault, 99, torch.device("cpu"), SMALL)
    assert not line["correct"], (line, detail)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_window_fault_is_not_correct(fault):
    """A fault of the optimisation's window alone, after the steps that
    set-up runs and checks: the window's last step catches it.  (At 16x16
    some seeds' samples leave the albedo's gradient at 0, which no scaling
    of it can show; this one's is not.)"""
    line, detail = faulty_run("knot2048.invert", fault, 99,
                              torch.device("cpu"), SMALL, in_window=True)
    assert not line["correct"], (line, detail)
    over = [k for k, v in line["check"].items() if v["value"] > v["limit"]]
    assert all(k.startswith("last_") for k in over), over


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["half", "altered"])
def test_invert_faults_at_size(cuda_device, fault):
    """The readings of the optimisation cell's faults at its own size, on
    three seeds, planted in the window alone (a state left unchanged reads
    1 by its measure; the same faults from the first step on read 0.994
    and 0.0500 on the set-up steps)."""
    for seed in (821, 822, 823):
        line, detail = faulty_run("knot2048.invert", fault, seed,
                                  cuda_device, None, seconds=10.0,
                                  in_window=True)
        print(f"fault {fault} seed {seed} check {line['check']}")
        assert not line["correct"]
