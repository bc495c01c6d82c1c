"""Profile one full-width serving request on the card with torch.profiler.

    python -m spfsplatv2_tpu_torch.evaluation.profile_request

Builds the flagship encoder from a seeded random init (as chip_smoke.py
does), serves one warm-up request, then one request under
`torch.profiler` and prints one JSON line: the request's wall time, the
device's busy time and share (the sum of kernel times over the wall
time; one stream, so kernels do not overlap), the number of kernel
launches, and the kernels that took the most device time.
"""

from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from spfsplatv2_tpu_torch.evaluation.evaluator import evaluate_example
from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config, build_encoder


def synthetic_request(seed: int, hw: int, device: torch.device) -> dict:
    """2 context views + 1 target of random pixels, identity intrinsics
    centred, poses shifted along x."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], device=device)

    def view(offset):
        c2w = torch.eye(4, device=device)
        c2w[0, 3] = offset
        return {"image": torch.rand(1, hw, hw, 3, generator=gen, device=device),
                "intrinsics": k[None].clone(), "extrinsics": c2w[None],
                "near": torch.ones(1, device=device),
                "far": torch.full((1,), 100.0, device=device)}

    c0, c1, tgt = view(0.0), view(0.2), view(0.1)
    ctx = {key: torch.cat([c0[key], c1[key]]) for key in c0}
    return {"scene": f"request_{seed}", "context": ctx, "target": tgt}


def main(hw: int = 256, seed: int = 0) -> dict:
    dev = torch.device("cuda")
    encoder = build_encoder(SPFSplatV2Config(), seed=seed, device=dev)
    evaluate_example(encoder, synthetic_request(1, hw, dev), (hw, hw),
                     device=dev)
    request = synthetic_request(2, hw, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate_example(encoder, request, (hw, hw), device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name[:100], []).append(e.device_time_total / 1e3)
    top = sorted(((sum(v), len(v), k) for k, v in by_name.items()),
                 reverse=True)[:15]
    result = {
        "device": torch.cuda.get_device_name(0),
        "request_wall_ms_under_profiler": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches": len(kernels),
        "top_kernels_ms_count_name": top,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
