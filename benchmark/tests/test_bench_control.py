"""The control: the plain reference, computed in bfloat16 on its radiance
path (the step below the float32 the configurations state), put in the
program's place, has to come out not correct.  On the CPU at 16x16 here;
the card test reads it at each cell's own size on three seeds."""

import time

import pytest
import torch

from benchmark import core
from benchmark.reference import tracer
from conftest import SMALL


def control(cell, seed, device, overrides, seconds=1.0):
    """The numbers of the control in one run's place: the run's inputs,
    sample batches and cameras (and, of an optimisation, the program's
    state before its last step), the reference in bfloat16 for the
    program.  Also the run's own numbers."""
    c = core.Cell(cell)
    inputs, outputs, window, *_ = core.measure(c, seed, seconds, False,
                                               device, overrides)
    own, _ = core.judge(c, inputs, outputs, seed, device)
    numbers, _ = core.judge(c, inputs, outputs, seed, device, q=tracer.bf16)
    return c, numbers, own


@pytest.mark.parametrize("cell", ["knot2048.converge", "knot2048.invert"])
def test_control_is_not_correct(cell):
    c, numbers, own = control(cell, 5, torch.device("cpu"), SMALL)
    assert core.over_limits(c, numbers), numbers
    assert not core.over_limits(c, own), own


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["knot2048.converge", "knot2048.invert",
                                  "sylveon2048.interactive"])
def test_control_at_size(cuda_device, cell):
    # The optimisation's window runs some tens of steps, so that its last
    # step starts from a state as far along as a run's.
    seconds = 10.0 if cell.endswith(".invert") else 2.0
    for seed in (701, 702, 703):
        c, numbers, own = control(cell, seed, cuda_device, None, seconds)
        print(f"control {cell} seed {seed} {numbers} own {own}")
        assert core.over_limits(c, numbers), numbers
