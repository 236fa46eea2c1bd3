"""Shared fixtures of the benchmark's tests: the small CPU set-up."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A frame and mesh small enough for the plain versions on the CPU.
SMALL = {"render": {"width": 16, "height": 16},
         "mesh": {"n_tris_target": 1500}}


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
