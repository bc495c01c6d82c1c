"""CLI entry: train / test / eval_pose (torch port of
`spfsplatv2_tpu/main.py`).

Usage:
    python -m spfsplatv2_tpu_torch.main --config experiments/spfsplatv2/re10k.yaml \
        dataset.roots='[/data/re10k]' checkpointing.pretrained_weights=null
    python -m spfsplatv2_tpu_torch.main --config ... mode=test checkpointing.load=<dir>
    python -m spfsplatv2_tpu_torch.main --config ... mode=eval_pose checkpointing.load=<dir>

`--config` YAML files overlay the defaults in order and dotted
`key=value` overrides come last (config.py).  Everything runs on the
card; `--device cpu` runs the same path on the CPU with the kernels'
plain versions (for tests, at tiny sizes).

Data-parallel training over N processes:
    torchrun --standalone --nproc_per_node=N -m spfsplatv2_tpu_torch.main \
        --config experiments/spfsplatv2/re10k.yaml ...
Each process takes card LOCAL_RANK (modulo the cards there are) and
joins the group `torchrun` describes: over NCCL when every local rank
has a card of its own, over gloo when ranks share a card or with
`--device cpu`.  Each rank trains on its own `trainer.batch_size`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def _load_encoder(cfg, device):
    """The configured encoder with the weights of `checkpointing.load`."""
    from spfsplatv2_tpu_torch.models import get_encoder
    from spfsplatv2_tpu_torch.training.loop import load_checkpoint

    if not cfg.checkpointing.load:
        raise SystemExit(f"mode={cfg.mode} requires checkpointing.load")
    encoder = get_encoder(cfg.encoder, device=device)
    restored = load_checkpoint(cfg.checkpointing.load)
    encoder.load_state_dict(restored["encoder"], strict=True)
    return encoder.eval()


def init_distributed(device: str) -> tuple[str, bool]:
    """Join the process group that `torchrun`'s environment describes
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT):
    (this rank's device, whether this call created the group).  Without
    that environment, or in a group already joined, nothing happens."""
    import torch
    import torch.distributed as dist

    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device, False

    backend = "gloo"
    if device != "cpu":
        cards = torch.cuda.device_count()
        local = int(os.environ["LOCAL_RANK"])
        if int(os.environ.get("LOCAL_WORLD_SIZE", 1)) <= cards:
            backend = "nccl"
        device = f"cuda:{local % cards}"
        torch.cuda.set_device(device)
    dist.init_process_group(backend)
    return device, True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", action="append", default=[])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from spfsplatv2_tpu_torch.config import load_config

    cfg = load_config(args.config, args.overrides)
    device, joined = init_distributed(args.device)
    try:
        return _run(cfg, device)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(cfg, device) -> int:
    if cfg.mode == "train":
        from spfsplatv2_tpu_torch.training.loop import (
            run_training,
            save_checkpoint,
        )

        def log(step, metrics):
            msg = " ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items()))
            print(f"step {step}: {msg}", flush=True)

        result = run_training(cfg, log_fn=log, device=device)
        save_checkpoint(
            Path(cfg.output_dir) / "checkpoints", result["state"], -1
        )
        print(json.dumps(result["metrics"], indent=2))
        return 0

    if cfg.mode == "test":
        from spfsplatv2_tpu_torch.config import make_sampler_from_config
        from spfsplatv2_tpu_torch.data.dataset import ChunkedSceneDataset
        from spfsplatv2_tpu_torch.evaluation.benchmarker import Benchmarker
        from spfsplatv2_tpu_torch.evaluation.evaluator import (
            EvalConfig,
            RunningMetricTables,
            evaluate_example,
            summarize_and_dump,
        )
        from spfsplatv2_tpu_torch.losses.lpips import get_lpips

        sampler = make_sampler_from_config(cfg, stage="test")
        dataset = ChunkedSceneDataset(cfg.dataset, sampler, stage="test")
        encoder = _load_encoder(cfg, device)
        lpips, lpips_calibrated = get_lpips(
            cfg.loss.use_lpips, cfg.loss.lpips_weights_path, device=device
        )

        eval_cfg = EvalConfig(
            align_pose=cfg.test.align_pose,
            pose_align_steps=cfg.test.pose_align_steps,
            opt_lr=cfg.test.opt_lr,
            save_images=cfg.test.save_image,
            save_video=cfg.test.save_video,
            output_path=cfg.test.output_path,
            use_estimated_focal=getattr(
                cfg.encoder.variant_cfg, "estimating_focal", False
            ),
        )
        bench = Benchmarker(device)
        tables = RunningMetricTables()
        results = []
        for example in dataset.epoch(0):
            results.append(
                evaluate_example(
                    encoder, example, tuple(cfg.image_shape), cfg.decoder,
                    eval_cfg, lpips_params=lpips,
                    lpips_calibrated=lpips_calibrated, benchmarker=bench,
                    device=device,
                )
            )
            # Running console tables after every scene.
            tables.update(results[-1])
            print(tables.render(), flush=True)
        summary = summarize_and_dump(results, cfg.test.output_path, bench)
        print(json.dumps(summary, indent=2))
        return 0

    if cfg.mode == "eval_pose":
        # Pose-only evaluation: feed-forward pose error + PnP-from-pointmap
        # baseline over the test split.
        from spfsplatv2_tpu_torch.config import make_sampler_from_config
        from spfsplatv2_tpu_torch.data.dataset import ChunkedSceneDataset
        from spfsplatv2_tpu_torch.evaluation.pose_evaluator import (
            dump_pose_eval,
            evaluate_poses,
        )

        sampler = make_sampler_from_config(cfg, stage="test")
        dataset = ChunkedSceneDataset(cfg.dataset, sampler, stage="test")
        encoder = _load_encoder(cfg, device)
        result = evaluate_poses(encoder, dataset.epoch(0))
        summary = dump_pose_eval(result, cfg.test.output_path)
        print(json.dumps(summary, indent=2))
        return 0

    raise SystemExit(f"unknown mode {cfg.mode!r}")


if __name__ == "__main__":
    sys.exit(main())
