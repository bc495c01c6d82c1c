"""The plain reference agrees with the port at a tiny width, both in
float32 on the CPU: the harness's own comparison of a training cell (each
step's loss, the first gradients, the changes after three updates) and
of a serving cell (the render, the Gaussians, the poses)."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny_cell

# float32 on both sides: the port's kernels' plain versions against their
# frozen copies, and float32 sums in another order (the remat recompute,
# the microbatches of the reference).
TOL = 1e-4


@pytest.mark.parametrize("workload", ["v2-train-256-b16", "v2l-train-224-b10",
                                      "v2-serve-256", "v2-serve-1024"])
def test_portbench_reference_matches_port(workload):
    torch.set_num_threads(2)
    cell = tiny_cell(workload, {"limits": {}})
    cell.config["encoder"] = harness.all_float32(cell.config["encoder"])
    out = harness.run_cell(cell, 2**31 + 5, 0.0, False, torch.device("cpu"),
                           0.0, log=lambda s: None)
    assert out.failed == 0 and out.readings.items >= 1
    assert out.numbers and all(v < TOL for v in out.numbers.values()), \
        out.numbers


def test_portbench_reference_moves_every_leaf():
    """Every leaf's first gradient and change are read: the comparison
    covers the whole encoder, and the first updates (the recipe's warm-up
    start, 5e-9 a step for the pretrained part) move every leaf but the
    LayerNorm scales at 1.0, where float32's spacing is 1.2e-7."""
    torch.set_num_threads(2)
    cell = tiny_cell("v2-train-256-b16")
    ref = harness.reference_train(cell, 11, torch.device("cpu"),
                                  cell.traffic["batch"])
    plan, _ = harness.plans(cell)
    assert set(ref["grad"]) == set(ref["change"]) == {l.name for l in plan}
    unmoved = {k for k, v in ref["change"].items() if v == 0}
    assert all("norm" in k and k.endswith(".weight") for k in unmoved)
    assert len(unmoved) < len(plan) / 10
