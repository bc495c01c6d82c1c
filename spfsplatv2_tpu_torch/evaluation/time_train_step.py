"""Time the flagship's train step (b = 16 at 256^2) on the card, for the
port in a checkout named on the command line, so that two versions can
be timed in turns in one call on one card:

    python spfsplatv2_tpu_torch/evaluation/time_train_step.py [--tree DIR] [--steps N]

Imports `spfsplatv2_tpu_torch` from DIR (default: the checkout that holds
this file), builds the full-width encoder from a seeded random init and
the step of `profile_request` (2 context views + 1 target, seeded LPIPS,
the re10k optimizer recipe), runs one step to warm up, then N steps
(default 4), each timed on the host clock to a synchronize, then one
more under `torch.profiler`.  Prints one JSON line: the tree, the card
and its power limit, each step's ms, the peak device memory, and the
profiled step's device busy time, its kernel launches, and the device
time of cuDNN's FFT-path kernels (names holding "fft" or "cf32").
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--steps", type=int, default=4)
    args = parser.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch
    from torch.profiler import ProfilerActivity, profile

    import spfsplatv2_tpu_torch
    from spfsplatv2_tpu_torch.evaluation import profile_request
    from spfsplatv2_tpu_torch.evaluation.evaluator import disable_tf32
    from spfsplatv2_tpu_torch.models import EncoderSelectorConfig, get_encoder

    if Path(spfsplatv2_tpu_torch.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"imported the port from {spfsplatv2_tpu_torch.__file__}"
                         f", not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("time_train_step: no CUDA device")
    dev = torch.device("cuda")
    disable_tf32()
    encoder = get_encoder(EncoderSelectorConfig(name="spfsplatv2"), seed=0,
                          device=dev)
    step = profile_request._runner("train", encoder, 256, 0, dev)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    fft = [e for e in kernels if "fft" in e.name.lower() or "cf32" in e.name]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    result = {"tree": str(tree), "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "batch": 16, "image_size": 256,
              "step_ms": step_ms, "peak_bytes": peak,
              "profiled_device_busy_ms": sum(e.device_time_total
                                             for e in kernels) / 1e3,
              "profiled_launches": len(kernels),
              "profiled_fft_path_ms": sum(e.device_time_total
                                          for e in fft) / 1e3,
              "profiled_fft_path_launches": len(fft)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
