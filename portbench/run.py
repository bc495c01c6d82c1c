"""The benchmark of the PyTorch/CUDA port `spfsplatv2_tpu_torch`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  The run makes its weights and traffic from `--seed`, warms up
(set-up: imports, the kernels' build under `build/kernels/`, weights,
the cell's first steps or requests), measures for `--seconds`, checks
what the timed path produced against the plain reference in
`portbench/reference/`, and prints one JSON line last on standard
output: with `--trace 0` the cell's end-to-end metrics, with `--trace 1`
its per-layer metrics, read from a profiled segment after the window.
The numbers compared, each beside its limit, are the last lines on
standard error and the last key ("check") of the result.  It exits with
another code than 0, and prints no result, without the card(s), or when
JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache at a fixed path inside the checkout (the
# port's own nvcc builds go to build/kernels/ there).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness, roofline

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(
        args.workload)
    if chips is None:
        log(f"unknown workload {args.workload!r}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    log(f"card: {roofline.power_limit()}")
    outcome = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), device, T_START, log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded: {bad}")
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1}
    return report(cell, outcome, bool(args.trace), device)


def report(cell, outcome, trace: bool, device: dict) -> int:
    """Print the numbers compared and the result's line; returns 0."""
    from portbench import harness, roofline, view_masked

    r = outcome.readings
    log(f"launches a {'step' if r.kind == 'train' else 'request'}: "
        + json.dumps({k: v for k, v in r.launches.items() if v}))
    if r.kind == "serve":
        log(f"requests in the window: {r.items} (+{outcome.failed} failed)")
    log(f"setup_s {r.setup_s:.3f}, window {r.window_s:.3f} s, items "
        f"{r.items}")
    log(f"check details: {json.dumps({**outcome.numbers, **outcome.extra})}")
    correct, check = harness.judge(cell, outcome)
    device = {**device, "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": correct, "attempted": outcome.attempted,
              "failed": outcome.failed,
              "metrics": harness.metrics_of(cell, r, trace),
              "device": device}
    if trace and r.trace is not None:
        device["busy_s"] = r.trace.busy_s
        device["window_s"] = r.trace.window_s
        log(f"device activity kinds: {json.dumps(r.trace.activity_kinds)}")
        kernels = {**roofline.KERNELS, "vm_fwd": view_masked.KERNEL}
        log("kernels' device seconds and launches in the traced segment: "
            + json.dumps({k: r.trace.time_by_name(n)
                          for k, n in kernels.items()}))
        result["breakdown"] = r.trace.breakdown()
    result["check"] = check
    for name, c in check.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
