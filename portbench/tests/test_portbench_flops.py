"""The model FLOP counts stored with the configurations are what
`FlopCounterMode` counts over the reference on meta tensors."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import flops

BENCH = Path(__file__).resolve().parents[1]
STORED = [(c.stem, t) for c in sorted((BENCH / "configs").glob("*.json"))
          for t in json.loads(c.read_text()).get("model_flops", {})]


@pytest.mark.parametrize("config,traffic", STORED)
def test_portbench_stored_flops(config, traffic):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    assert flops.count(cfg, tr) == cfg["model_flops"][traffic]


def test_portbench_flagship_forward_flops():
    """The flagship's 2 + 1-view forward at 256^2: 1.073 TFLOP, as a
    meta-tensor count of the port's encoder gives."""
    cfg = json.loads((BENCH / "configs" / "spfsplatv2-re10k.json").read_text())
    tr = json.loads((BENCH / "traffic" / "serve-256.json").read_text())
    assert abs(flops.count(cfg, tr) / 1.073e12 - 1) < 1e-3
