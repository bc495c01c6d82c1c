"""The result's line has the contract's keys, the check last; the run
refuses a machine without the card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from portbench import harness, run
from portbench.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _last_line(capsys, trace: bool, workload: str) -> dict:
    torch.set_num_threads(2)
    cell = tiny_cell(workload, harness.load_cell(workload).limits)
    out = harness.run_cell(cell, 12, 0.0, trace, torch.device("cpu"), 0.0,
                           log=lambda s: None)
    assert run.report(cell, out, trace, {"platform": "gpu", "kind": "test",
                                         "count": 1}) == 0
    captured = capsys.readouterr()
    assert captured.err.strip().splitlines()[-1].startswith("check ")
    return json.loads(captured.out.strip().splitlines()[-1])


def test_portbench_result_keys(capsys):
    line = _last_line(capsys, False, "v2-serve-256")
    assert list(line) == KEYS + ["check"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"requests_per_s", "request_ms_p90",
                                    "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["check"]) == {"image_tile_gap", "pose_gap"}
    assert all(set(c) == {"value", "limit"} for c in line["check"].values())


def test_portbench_result_keys_traced(capsys):
    line = _last_line(capsys, True, "v2-train-256-b16")
    assert list(line) == KEYS + ["breakdown", "check"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["check"]) == {"loss_gap", "gaussian_gap", "pose_gap",
                                  "grad_gap", "change_gap"}


def test_portbench_refuses_without_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "v2-serve-256",
         "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    if torch.cuda.is_available():
        return
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_portbench_idle_share_against_the_untraced_window():
    # 0.5 s busy a step in the trace, whose host time the profiler
    # stretched to 3 s a step; the untraced window took 1 s a step.
    from portbench import trace

    segment = trace.Trace(window_s=6.0, items=2, busy_s=1.0)
    r = harness.Readings("train", {}, {}, 1.0, 10.0, 10, 10, [], {}, None,
                         None, {}, segment)
    read = harness.load_metric("device.idle.train")
    assert abs(read(r) - 50.0) < 1e-9
    assert harness.load_metric("device.idle.serve")(r) is None
