"""Profile one step of a full-width path on the card with torch.profiler.

    python -m spfsplatv2_tpu_torch.evaluation.profile_request [serving|align|train] [256|1024]
    python -m spfsplatv2_tpu_torch.evaluation.profile_request [serving|align|train] 224 spfsplatv2l
    python -m spfsplatv2_tpu_torch.evaluation.profile_request [serving|train] 1024 spfsplatv2 float32

Builds the encoder (the flagship, or the one named by the third
argument: "spfsplatv2l" is the VGGT-1B family at the
experiments/spfsplatv2-l presets' widths) from a seeded random init (as
chip_smoke.py does), runs the path once to warm up, once timed on the
host clock, then once under `torch.profiler` (`utils/profiling.trace`),
which writes the Chrome trace to
`outputs/profile/<path>_<size>_<encoder>/trace.json`: the program's
`spfsplat:` spans over the card's kernels, in Perfetto.  Prints one JSON
line: the untimed and the profiled wall time, the device's busy time
(the union of the card's kernel, memcpy and memset intervals in the
trace) and its share of the untraced wall time (the profiler stretches
host time), the number of device operations, the peak device memory,
the kernels that took the most device time, and K5's flash-attention
kernels apart.  The paths:
  * serving: one request (2 context views + 1 target);
  * align: one request with test-time pose alignment, 10 steps;
  * train: one `make_train_step` step at the preset's batch (seeded
    LPIPS, the re10k optimizer recipe).
The second argument is the image size: 256 (default) or 1024 for the
flagship, where at 1024 every self-attention takes flash attention (K5),
the binning takes the quantized depth key and a train step takes b = 2;
224 for the VGGT family (b = 10 in microbatches of 5, the memory
guard's choice on the 80 GB card).  The fourth argument sets the
flagship backbone's compute dtype (default bfloat16; float32 sends every
1024^2 self-attention to K5's float32 kernels).
"""

from __future__ import annotations

import json
import sys
import time

from pathlib import Path

import torch

from spfsplatv2_tpu_torch.evaluation.evaluator import EvalConfig, evaluate_example
from spfsplatv2_tpu_torch.models import EncoderSelectorConfig, get_encoder
from spfsplatv2_tpu_torch.models.croco.backbone import CrocoBackboneConfig
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig, LONG_CONTEXT_DECODER
from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config
from spfsplatv2_tpu_torch.utils.profiling import busy_us, device_ops, trace

ALIGN_STEPS = 10
# Image size -> (decoder config, train batch, microbatch).
SIZES = {224: (DecoderConfig(), 10, 5), 256: (DecoderConfig(), 16, None),
         1024: (LONG_CONTEXT_DECODER, 2, None)}


def _views(gen, b, offsets, hw, device) -> dict:
    """b scenes of random pixels, one view per offset along x, centred
    identity intrinsics."""
    v = len(offsets)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], device=device)
    c2w = torch.eye(4, device=device).repeat(b, v, 1, 1)
    c2w[..., 0, 3] = torch.tensor(offsets, device=device)
    return {"image": torch.rand(b, v, hw, hw, 3, generator=gen, device=device),
            "intrinsics": k.expand(b, v, 3, 3).clone(), "extrinsics": c2w,
            "near": torch.ones((b, v), device=device),
            "far": torch.full((b, v), 100.0, device=device)}


def synthetic_request(seed: int, hw: int, device: torch.device) -> dict:
    """2 context views + 1 target, poses shifted along x."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ctx = {k: v[0] for k, v in _views(gen, 1, [0.0, 0.2], hw, device).items()}
    tgt = {k: v[0] for k, v in _views(gen, 1, [0.1], hw, device).items()}
    ctx["overlap"] = 0.5
    return {"scene": f"request_{seed}", "context": ctx, "target": tgt}


def synthetic_batch(seed: int, b: int, hw: int, device: torch.device) -> dict:
    """A training batch of b scenes of 2 context views + 1 target."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"context": _views(gen, b, [0.0, 0.2], hw, device),
            "target": _views(gen, b, [0.1], hw, device)}


def _runner(path: str, encoder, hw: int, seed: int, dev):
    dec_cfg, train_batch, microbatch = SIZES[hw]
    if path == "serving":
        request = synthetic_request(seed + 1, hw, dev)
        return lambda: evaluate_example(encoder, request, (hw, hw), dec_cfg,
                                        device=dev)
    if path == "align":
        request = synthetic_request(seed + 1, hw, dev)
        cfg = EvalConfig(align_pose=True, pose_align_steps=ALIGN_STEPS)
        return lambda: evaluate_example(encoder, request, (hw, hw), dec_cfg,
                                        eval_cfg=cfg, device=dev)
    if path == "train":
        from spfsplatv2_tpu_torch.losses.lpips import build_lpips
        from spfsplatv2_tpu_torch.training.optim import Optimizer, OptimizerConfig
        from spfsplatv2_tpu_torch.training.step import (
            LossConfig,
            init_train_state,
            make_train_step,
        )

        optimizer = Optimizer(OptimizerConfig(), encoder.named_parameters())
        step = make_train_step(encoder, optimizer, (hw, hw), dec_cfg,
                               lpips=build_lpips(seed, dev),
                               loss_cfg=LossConfig(), microbatch=microbatch)
        state = init_train_state(encoder, optimizer)
        batch = synthetic_batch(seed + 1, train_batch, hw, dev)
        return lambda: step(state, batch)
    raise ValueError(f"unknown path {path!r}: serving, align or train")


def _selector(encoder_name: str, compute_dtype: str) -> EncoderSelectorConfig:
    if compute_dtype == "bfloat16":
        return EncoderSelectorConfig(name=encoder_name)
    if encoder_name != "spfsplatv2":
        raise ValueError("a compute dtype is set here for the flagship "
                         "spfsplatv2 only")
    return EncoderSelectorConfig(name=encoder_name, spfsplatv2=SPFSplatV2Config(
        backbone=CrocoBackboneConfig(compute_dtype=compute_dtype)))


def main(path: str = "serving", hw: int = 256, encoder_name: str = "spfsplatv2",
         compute_dtype: str = "bfloat16", seed: int = 0) -> dict:
    dev = torch.device("cuda")
    encoder = get_encoder(_selector(encoder_name, compute_dtype), seed=seed,
                          device=dev)
    run = _runner(path, encoder, hw, seed, dev)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats(dev)
    log_dir = Path("outputs/profile") / f"{path}_{hw}_{encoder_name}"
    with trace(log_dir):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    ops = device_ops(log_dir / "trace.json")
    busy_ms = busy_us(ops) / 1e3
    by_name: dict[str, list[float]] = {}
    for s, e, name in ops:
        by_name.setdefault(name[:100], []).append((e - s) / 1e3)
    top = sorted(((sum(v), len(v), k) for k, v in by_name.items()),
                 reverse=True)[:15]
    # K5's kernels by name, whether or not they make the top 15.
    flash = {k: [sum(v), len(v)] for k, v in by_name.items() if "flash_" in k}
    result = {
        "path": path,
        "image_size": hw,
        "encoder": encoder_name,
        "compute_dtype": compute_dtype,
        "device": torch.cuda.get_device_name(0),
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "wall_ms": wall_ms,
        "wall_ms_under_profiler": traced_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_ops": len(ops),
        "top_kernels_ms_count_name": top,
        "flash_kernels_ms_count": flash,
        "trace": str(log_dir / "trace.json"),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(*sys.argv[1:2], *map(int, sys.argv[2:3]), *sys.argv[3:5])
