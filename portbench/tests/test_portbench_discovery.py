"""A configuration, a traffic mix and a per-layer metric that a later
change drops in as new files are found by their names, with no edit of
the harness."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from portbench import harness
from portbench.tests.tiny import TINY_ENCODER, merge

ROOT = Path(__file__).resolve().parents[2]


def test_portbench_new_files_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    for part in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "portbench" / part, bench / part)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "spfsplatv2-re10k.json")
                        .read_text())
    config = merge(config, {"encoder": TINY_ENCODER["spfsplatv2-re10k"]})
    config["model_flops"] = {"serve-tiny": 1.0e9}
    (bench / "configs" / "tiny-new.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "serve-256.json").read_text())
    traffic.update(image_size=32, pool=2, warmup=1, check_within=2,
                   check_requests=1, gaussian_sample=8, trace_items=1)
    (bench / "traffic" / "serve-tiny.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "serve.requests_done.py").write_text(
        "def read(r):\n    return float(r.items)\n")
    spec["configs"].append({"name": "tiny-new", "source": "test",
                            "file": "portbench/configs/tiny-new.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-serve", "config": "tiny-new",
                              "traffic": "serve-tiny", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "v2-serve-256" in m.get("workloads", []):
            m["workloads"].append("tiny-serve")
    spec["per_layer"].append({"name": "serve.requests_done", "unit": "n",
                              "better": "higher", "source": "host_clock",
                              "layer": "request", "moves": "requests_per_s",
                              "workloads": ["tiny-serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("tiny-serve", root=tmp_path)
    assert cell.config["model_flops"] == {"serve-tiny": 1.0e9}
    assert cell.traffic["image_size"] == 32
    assert "serve.requests_done" in {m["name"] for m in cell.per_layer}
    torch.set_num_threads(2)
    out = harness.run_cell(cell, 3, 0.0, True, torch.device("cpu"), 0.0,
                           log=lambda s: None)
    got = harness.metrics_of(cell, out.readings, True, bench=bench)
    assert got["serve.requests_done"]["value"] == out.readings.items
    assert got["serve.mfu"]["value"] > 0
