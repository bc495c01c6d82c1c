"""The readings that a cell's limits are set from, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds a,b,... \
        [--control-seeds c,d,e] [--fault half_batch:f,g,h] \
        [--witness-seeds i,j] [--out FILE]

For each of `--seeds`, a sound run of the program with a window of no
length (the cell's set-up, its checked steps or its sampled requests,
then the reference); for each of `--control-seeds`, the control (the
reference one precision step down, `reference/precision.py`) against the
reference; for each fault of `faults.py` named with its seeds, the run
with that fault planted in the program; for each of `--witness-seeds`,
the program itself with every compute dtype float32 and TF32 off (the
reference's arithmetic), which shows whether a gap between the program
and the reference comes from the configuration's bfloat16 or from the
program.  Prints one JSON line a reading, as it comes (and appends it to
`--out`), and last the largest sound reading and the smallest control
and fault reading of each number compared.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    from portbench import faults, harness
    from portbench.reference import precision

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault", action="append", default=[])
    parser.add_argument("--witness-seeds", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    lines = []
    out_path = Path(args.out) if args.out else None
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text("")
    t0 = time.perf_counter()

    def write(line):
        print(json.dumps(line), flush=True)
        if out_path:
            with out_path.open("a") as f:
                f.write(json.dumps(line) + "\n")

    def emit(kind, seed, numbers, **extra):
        line = {"kind": kind, "seed": seed, **numbers, **extra,
                "allocated_gib": torch.cuda.memory_allocated(device) / 2**30,
                "elapsed_s": time.perf_counter() - t0}
        lines.append(line)
        write(line)

    # The control's microbatch: the guard's choice in the sound runs.
    mb = cell.traffic.get("batch")
    for seed in seeds(args.seeds):
        out = harness.run_cell(cell, seed, 0.0, False, device,
                               time.perf_counter())
        mb = out.extra.get("microbatch", mb)
        emit("sound", seed, out.numbers, failed=out.failed, **out.extra)
    witness = dataclasses.replace(cell, config={
        **cell.config, "encoder": harness.all_float32(cell.config["encoder"])})
    for seed in seeds(args.witness_seeds):
        with precision.tf32(False):
            out = harness.run_cell(witness, seed, 0.0, False, device,
                                   time.perf_counter())
        emit("witness_float32", seed, out.numbers, **out.extra)
    train = cell.traffic["kind"] == "train"
    for seed in seeds(args.control_seeds):
        if train:
            ref = harness.reference_train(cell, seed, device, mb)
            ctl = harness.reference_train(cell, seed, device, mb,
                                          control=True)
            emit("control", seed, harness.train_numbers(ctl, ref),
                 **harness.train_diagnostics(ctl, ref))
        else:
            sample, _ = harness.serve_sample(cell, seed)
            ref = harness.reference_serve(cell, seed, device, sample)
            ctl = harness.reference_serve(cell, seed, device, sample,
                                          control=True)
            emit("control", seed, harness.serve_numbers(ctl, ref),
                 **harness.serve_diagnostics(ctl, ref))
    for spec in args.fault:
        name, _, fs = spec.partition(":")
        for seed in seeds(fs):
            with faults.FAULTS[name]():
                out = harness.run_cell(cell, seed, 0.0, False, device,
                                       time.perf_counter())
            emit(name, seed, out.numbers, **out.extra)
    summary = {}
    for line in lines:
        for k, v in line.items():
            if not k.endswith("_gap") or line["kind"].startswith("witness"):
                continue
            s = summary.setdefault(k, {})
            if line["kind"] == "sound":
                s["lower"] = max(s.get("lower", 0.0), v)
            else:
                key = f"upper_{line['kind']}"
                s[key] = min(s.get(key, float("inf")), v)
    write({"summary": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
