"""Evaluation index generation: fixed (context, target) pairs by overlap
(torch port of `spfsplatv2_tpu/evaluation/index_generator.py`).

From up to 8 seed frames of each scene (a seeded permutation), walk away
in steps of 5 frames until the frustum overlap of the pair falls inside
[min_overlap, max_overlap], then draw the target views inside the gap.
The overlap is the fraction of view A's rays, sampled on a 16 x 16 grid
at 5 depths, that land inside view B (the smaller of both directions).
The numpy `default_rng(cfg.seed)` stream and the JSON schema
({scene: {"context": [l, r], "target": [...], "overlap": x} or null})
are the JAX function's, so the same poses give the same index.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.geometry.projection import sample_image_grid, unproject


@dataclass(frozen=True)
class IndexGeneratorConfig:
    num_target_views: int = 3
    min_overlap: float = 0.4
    max_overlap: float = 0.8
    min_distance: int = 45
    max_distance: int = 200
    output_path: str = "outputs/evaluation_index.json"
    seed: int = 0


def frustum_overlap(
    c2w_a: torch.Tensor, k_a: torch.Tensor, c2w_b: torch.Tensor,
    k_b: torch.Tensor, grid: int = 16, depths=(0.5, 1.0, 2.0, 4.0, 8.0),
) -> torch.Tensor:
    """Fraction of view A's rays visible in view B (symmetrized min)."""

    def one_way(c2w_src, k_src, c2w_dst, k_dst):
        coords, _ = sample_image_grid((grid, grid), device=c2w_src.device)
        coords = coords.reshape(-1, 2)
        total = 0.0
        for d in depths:
            cam = unproject(coords, torch.full((grid * grid,), d,
                                               device=coords.device), k_src)
            world = (torch.einsum("ij,nj->ni", c2w_src[:3, :3], cam)
                     + c2w_src[:3, 3])
            # Normalized intrinsics: "inside" is [0, 1]^2.
            xy = se3.project_to_cam(world[None], c2w_dst[None], k_dst[None])[0]
            w2c = se3.inverse_se3(c2w_dst)
            z = (torch.einsum("ij,nj->ni", w2c[:3, :3], world)
                 + w2c[:3, 3])[:, 2]
            inside = ((xy[:, 0] >= 0) & (xy[:, 0] <= 1)
                      & (xy[:, 1] >= 0) & (xy[:, 1] <= 1) & (z > 0))
            total = total + torch.mean(inside.to(torch.float32))
        return total / len(depths)

    return torch.minimum(one_way(c2w_a, k_a, c2w_b, k_b),
                         one_way(c2w_b, k_b, c2w_a, k_a))


def generate_index_for_scene(
    extrinsics: np.ndarray,
    intrinsics: np.ndarray,
    cfg: IndexGeneratorConfig,
    rng: np.random.Generator,
    device: str | torch.device = "cuda",
):
    """Returns {context: [l, r], target: [...], overlap} or None (no
    valid pair)."""
    n = extrinsics.shape[0]

    def pose(i):
        return (torch.as_tensor(extrinsics[i], dtype=torch.float32,
                                device=device),
                torch.as_tensor(intrinsics[i], dtype=torch.float32,
                                device=device))

    order = rng.permutation(n)
    for seed_frame in order[: min(8, n)]:
        for step in range(cfg.min_distance, cfg.max_distance + 1, 5):
            right = seed_frame + step
            if right >= n:
                break
            ov = float(frustum_overlap(*pose(seed_frame), *pose(right)))
            if ov < cfg.min_overlap:
                break
            if ov <= cfg.max_overlap:
                inner = np.arange(seed_frame + 1, right)
                if len(inner) < cfg.num_target_views:
                    break
                target = np.sort(
                    rng.choice(inner, cfg.num_target_views, replace=False)
                )
                return {
                    "context": [int(seed_frame), int(right)],
                    "target": [int(t) for t in target],
                    "overlap": ov,
                }
    return None


def generate_index(dataset, cfg: IndexGeneratorConfig,
                   device: str | torch.device = "cuda") -> dict:
    """dataset: iterable of raw chunk examples (`data.chunk_io.load_chunk`);
    writes `cfg.output_path` and returns the index."""
    from spfsplatv2_tpu_torch.data.chunk_io import decode_poses

    rng = np.random.default_rng(cfg.seed)
    index = {}
    for example in dataset:
        extrinsics, intrinsics = decode_poses(example["cameras"])
        index[example["key"]] = generate_index_for_scene(
            extrinsics, intrinsics, cfg, rng, device=device
        )
    out = Path(cfg.output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(index, indent=2))
    return index
