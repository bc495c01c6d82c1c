"""Flagship convergence proof: overfit ONE synthetic scene on the card
(torch port of `scripts/overfit_flagship.py`).

Trains the full-size SPFSplatV2 encoder (the re10k preset, 608,017,854
parameters) from a seeded init on one synthetic 256x256 scene
(`scene_000`, 30 frames; reference overfit harness:
src/dataset/dataset_re10k.py:93-95,121-124) with the script's
overrides: b = 2, 3000 steps, LPIPS off, backbone lr multiplier 1,
`max_grad_skip` 50.  Logs the PSNR curve every 25 steps and writes
`artifacts/overfit_flagship_torch.json` in the JAX artifact's layout,
plus the card (`nvidia-smi` name and power limit), the parameter count,
the run's seconds, its peak device memory and the kernels' launches.
The recipe's bar: a best train PSNR above 25.

Usage (on the card; the 3000 steps took 51 min on an H100):
    python -m spfsplatv2_tpu_torch.overfit [--steps 3000] [--root DIR] \
        [--out FILE] [key=value ...]

`--root` is the work directory: the scene under `<root>/train`, the
run's checkpoints under `<root>/run/checkpoints` (every 1000 steps, ~7.3
GB each) and its curve so far in `<root>/run/curve.json`.  The recipe
resumes: run the same command again on the same `--root` and training
continues from the newest checkpoint, the curve from the interim file.
Trailing `key=value` overrides come after the recipe's (the tests run it
at tiny widths on the CPU with `--device cpu`).  The bar is asserted
only for a run of the recipe's full length.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
PRESET = REPO / "experiments/spfsplatv2/re10k.yaml"
MAX_STEPS = 3000
BAR_PSNR = 25.0
SCENE = "scene_000"
NUM_FRAMES = 30
IMAGE_HW = (256, 256)

# `scripts/overfit_flagship.py`'s overrides, in its order and unchanged;
# its two f-string entries are templates here ({root}, {max_steps}).
# The script's comments say why each departs from the preset: the
# synthetic scenes' near = 1, no MASt3R checkpoint (a from-scratch
# proof), the full backbone lr (0.1x starves a random ViT-L), and
# `max_grad_skip` 50 (from-scratch gradients spike past 5 early).
OVERFIT_OVERRIDES = (
    "dataset.roots=[{root}]",
    "dataset.input_image_shape=[256,256]",
    "dataset.original_image_shape=[256,256]",
    "dataset.augment=false",
    "dataset.overfit_to_scene=scene_000",
    "dataset.near=1.0",
    "checkpointing.pretrained_weights=null",
    "view_sampler.min_distance_between_context_views=4",
    "view_sampler.max_distance_between_context_views=8",
    "view_sampler.warm_up_steps=0",
    "trainer.batch_size=2",
    "loss.use_lpips=false",
    "optimizer.lr=2e-4",
    "optimizer.backbone_lr_multiplier=1.0",
    "optimizer.warm_up_steps=100",
    "optimizer.max_grad_skip=50.0",
    "optimizer.max_steps={max_steps}",
    "image_shape=[256,256]",
    "checkpointing.every_n_train_steps=1000",
    "checkpointing.resume=true",
    "output_dir=/tmp/overfit_flagship_out3",
    "train.print_log_every_n_steps=25",
)


def recipe_overrides(root: str | Path, max_steps: int = MAX_STEPS,
                     extra: tuple | list = ()) -> list[str]:
    """The script's overrides on `root`, then `output_dir` moved under
    `root` (the run writes nothing outside its work directory), then
    `extra`."""
    root = Path(root)
    ov = [o.format(root=root, max_steps=max_steps) for o in OVERFIT_OVERRIDES]
    return ov + [f"output_dir={root / 'run'}", *extra]


def device_line(device: torch.device) -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line, or the
    device type off the card."""
    if device.type != "cuda":
        return device.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def resume_step(ckpt_dir: Path) -> int:
    """The step a resumed run starts at: the newest checkpoint's (read
    memory-mapped, so the weights stay on disk), else 0."""
    from spfsplatv2_tpu_torch.training.loop import (
        latest_checkpoint,
        load_checkpoint,
    )

    latest = latest_checkpoint(ckpt_dir)
    return 0 if latest is None else int(load_checkpoint(latest)["step"])


def curve_entry(step: int, metrics: dict) -> dict:
    """One curve point, rounded as the JAX script rounds it."""
    return {
        "step": int(step),
        "loss": round(float(metrics["loss/total"]), 5),
        "psnr": round(float(metrics["train/psnr"]), 3),
        "mse": round(float(metrics["loss/mse"]), 6),
        "rot_deg": round(float(metrics.get("pose/context_rot_deg", -1)), 3),
        "gmax": round(float(metrics.get("grad/max", -1)), 4),
        "skipped": int(metrics.get("grad/skipped_steps", -1)),
    }


def run_overfit(root: str | Path, out: str | Path, steps: int = MAX_STEPS,
                device: str | torch.device = "cuda",
                extra: tuple | list = ()) -> dict:
    """Write the scene (once), train the recipe for `steps` steps and
    write the artifact to `out`; returns it."""
    from spfsplatv2_tpu_torch.config import load_config
    from spfsplatv2_tpu_torch.data.synthetic import write_synthetic_dataset
    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.training.loop import run_training

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "kernels' plain versions")
    root = Path(root).absolute()
    if not (root / "train").exists():
        write_synthetic_dataset(root, num_scenes=1, num_frames=NUM_FRAMES,
                                image_hw=IMAGE_HW)
    cfg = load_config([PRESET], recipe_overrides(root, steps, extra))
    run_dir = Path(cfg.output_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    interim = run_dir / "curve.json"
    start = resume_step(run_dir / "checkpoints") if cfg.checkpointing.resume else 0
    # The curve of the segments before this one (a resumed run).
    curve = [e for e in (json.loads(interim.read_text()) if interim.exists()
                         else []) if e["step"] < start]

    def log(step, metrics):
        entry = curve_entry(step, metrics)
        curve.append(entry)
        interim.write_text(json.dumps(curve))
        print(f"step {step}: loss {entry['loss']:.4f} "
              f"psnr {entry['psnr']:.2f} mse {entry['mse']:.5f} "
              f"rot {entry['rot_deg']:.2f} gmax {entry['gmax']:.3f} "
              f"skipped {entry['skipped']} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_training(cfg, max_steps=steps, log_fn=log, device=device)
    seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)

    psnrs = [e["psnr"] for e in curve]
    h, w = cfg.image_shape
    artifact = {
        "model": "SPFSplatV2 flagship (default config)" if not extra else
                 f"SPFSplatV2, re10k preset + {len(extra)} extra overrides",
        "scene": f"synthetic {SCENE}, {h}x{w}, b={cfg.trainer.batch_size}",
        # What this artifact does and does not demonstrate: end-to-end
        # gradient quality of the whole pipeline on the card, trained from
        # scratch at full lr on one synthetic scene with LPIPS off; not
        # the reference's regime (MASt3R fine-tune, LPIPS, real RE10K),
        # whose weights and data are not in the repository.
        "regime": "from-scratch, synthetic single scene, use_lpips=false",
        "not_demonstrated": "reference fine-tune regime "
                            "(MASt3R init + LPIPS + real RE10K)",
        "steps": steps,
        "final_psnr": psnrs[-1] if psnrs else None,
        "best_psnr": max(psnrs) if psnrs else None,
        "steps_per_s": round(result["metrics"]["time/steps_per_s"], 3),
        # `steps_per_s` covers this process's steps only (one segment).
        "steps_per_s_steps": [start, steps - 1],
        "device": device_line(device),
        "params": sum(p.numel() for p in result["encoder"].parameters()),
        "seconds": round(seconds, 2),
        "peak_bytes": peak,
        "guard": {"microbatch": result["guard"]["microbatch"],
                  "peak_gb": result["guard"]["peak_gb"]},
        # The segment's kernel launches: its steps and the guard's probe
        # (one forward and backward of the first batch).
        "launches": cuda_lib.launches(),
        "curve": curve,
    }
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    return artifact


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=MAX_STEPS)
    parser.add_argument("--root", default=str(REPO / "build" / "overfit"))
    parser.add_argument("--out", default=str(
        REPO / "artifacts" / "overfit_flagship_torch.json"))
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    artifact = run_overfit(args.root, args.out, args.steps, args.device,
                           args.overrides)
    print(json.dumps({k: v for k, v in artifact.items() if k != "curve"}),
          flush=True)
    if args.steps >= MAX_STEPS and not (
            artifact["best_psnr"] and artifact["best_psnr"] > BAR_PSNR):
        raise SystemExit(f"flagship overfit did not reach PSNR {BAR_PSNR}: "
                         f"{artifact['best_psnr']}")
    print("FLAGSHIP OVERFIT OK" if args.steps >= MAX_STEPS else
          f"overfit: {args.steps} steps (the bar holds for {MAX_STEPS})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
