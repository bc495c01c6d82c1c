"""The check that decides `correct`, driven through the rest of a run at a
tiny size on the CPU with each cell's own limits (`limits/<cell>.json`):
a sound run passes; the control (the reference one precision step down)
and every fault the cell can have, planted underneath the timed path,
come out not correct."""

from __future__ import annotations

import pytest
import torch

from portbench import faults, harness
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
TRAIN = ["v2-train-256-b16", "v2l-train-224-b10"]
SERVE = ["v2-serve-256", "v2-serve-1024", "v1-serve-1024"]
# The cells that compare the render (v1's is not compared: PERF.md
# section 2).
RENDER = ["v2-serve-256", "v2-serve-1024"]
CELL_FAULTS = [(w, f) for w in TRAIN
               for f in ("half_batch", "unchanged_state", "altered_loss")]
CELL_FAULTS += [(w, "altered_render") for w in RENDER]
# The flagship's 1024^2 cell holds the opacities (v1's sound tail reads
# too close to its control: PERF.md section 2).
CELL_FAULTS += [("v2-serve-1024", "altered_opacities")]


def _cell(workload):
    cell = tiny_cell(workload)
    cell.limits = harness.load_cell(workload).limits
    assert cell.limits, f"no limits/{workload}.json"
    cell.config["encoder"] = harness.all_float32(cell.config["encoder"])
    return cell


def _run(cell, seed):
    torch.set_num_threads(2)
    out = harness.run_cell(cell, seed, 0.0, False, CPU, 0.0,
                           log=lambda s: None)
    return harness.judge(cell, out)


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_portbench_sound_run_is_correct(workload):
    correct, check = _run(_cell(workload), 2**31 + 21)
    assert correct, check


def _control_numbers(cell, seed, device):
    if cell.traffic["kind"] == "train":
        mb = cell.traffic["batch"]
        ref = harness.reference_train(cell, seed, device, mb)
        ctl = harness.reference_train(cell, seed, device, mb, control=True)
        return harness.train_numbers(ctl, ref)
    sample, _ = harness.serve_sample(cell, seed)
    ref = harness.reference_serve(cell, seed, device, sample)
    ctl = harness.reference_serve(cell, seed, device, sample, control=True)
    return harness.serve_numbers(ctl, ref)


# At the tiny size the float8 control moves a training step's loss by
# 3e-4 to 3e-3 (2 + 2 layers, 32^2), under the 0.004 that the full size's
# readings set: the training cells' control is held on the card.
@pytest.mark.parametrize("workload", SERVE)
def test_portbench_control_is_not_correct(workload):
    torch.set_num_threads(2)
    cell = _cell(workload)
    seed = 2**31 + 22
    numbers = _control_numbers(cell, seed, CPU)
    limits = cell.limits["limits"]
    assert any(numbers[k] > v for k, v in limits.items()), numbers


@pytest.mark.parametrize("workload,fault", CELL_FAULTS)
def test_portbench_fault_is_not_correct(workload, fault):
    with faults.FAULTS[fault]():
        correct, check = _run(_cell(workload), 2**31 + 23)
    assert not correct, check


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_portbench_control_on_card(workload):
    """The control at the cell's own size on the card (the guard's
    microbatch for VGGT-1B: 10 on the 80 GB H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control at the cell's own size")
    cell = harness.load_cell(workload)
    numbers = _control_numbers(cell, 2**31 + 24, torch.device("cuda", 0))
    limits = cell.limits["limits"]
    assert any(numbers[k] > v for k, v in limits.items()), numbers
