"""The control on the card: each cell's configuration at its widths, a few
members, the program sound and its lower-precision control (the model's
matmuls in bf16 in the program's place).  The program comes out correct
and the control not.  Needs an NVIDIA GPU (the sweep kernels have no CPU
mode); skips without one."""

import time

import pytest
import torch

from benchmark.harness import driver
from benchmark.harness.layout import Layout

from conftest import CELLS, ROOT

SMALL = {
    "quadrotor_mlp.track_b2048": {"traffic": {
        "batch": 64, "lead_in": 2, "check_per_replan": 64}},
}


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, control):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    res = driver.run(Layout(ROOT), cell, 2 ** 32 + 5, 2.0, False,
                     t_start=time.perf_counter(), device="cuda",
                     overrides=SMALL[cell], control=control)
    assert res["correct"] is (not control), res["checks"]
