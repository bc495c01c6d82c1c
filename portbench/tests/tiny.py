"""Tiny cells for the CPU tests: the benchmark's own configuration and
traffic files with the encoder cut to a few narrow layers and the images
to a few patches (never used on the card)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import harness

BENCH = Path(__file__).resolve().parents[1]

TINY_ENCODER = {
    "spfsplatv2-re10k": {
        "backbone": dict(patch_size=16, enc_depth=2, enc_embed_dim=64,
                         enc_num_heads=4, dec_depth=2, dec_embed_dim=48,
                         dec_num_heads=4),
        "sh_degree": 1, "dpt_feature_dim": 32, "dpt_last_dim": 16,
        "dpt_layer_dims": [16, 24, 32, 48]},
    "spfsplatv2l-re10k": {
        "aggregator": dict(patch_size=14, embed_dim=32, depth=2, num_heads=2,
                           num_register_tokens=2,
                           dinov2=dict(patch_size=14, embed_dim=32, depth=1,
                                       num_heads=2, num_register_tokens=2,
                                       native_grid=4)),
        "camera_head": dict(dim_in=64, trunk_depth=1, num_heads=2),
        "sh_degree": 1},
}
# SPFSplat v1 at the flagship's tiny widths (the same backbone keys).
TINY_ENCODER["spfsplat-re10k"] = TINY_ENCODER["spfsplatv2-re10k"]
TINY_TRAFFIC = {"train": dict(batch=4, pool=4, trace_items=1,
                              gaussian_sample=64),
                "serve": dict(pool=3, warmup=1, check_within=4,
                              check_requests=2, gaussian_sample=64,
                              trace_items=1)}


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def tiny_cell(workload: str, limits: dict | None = None) -> harness.Cell:
    cell = harness.load_cell(workload)
    cell.config = merge(cell.config,
                        {"encoder": TINY_ENCODER[cell.config_name]})
    patch = 14 if cell.config_name == "spfsplatv2l-re10k" else 16
    cell.traffic = merge(cell.traffic, {
        **TINY_TRAFFIC[cell.traffic["kind"]], "image_size": 2 * patch})
    cell.traffic["decoder"]["rasterizer"]["depth_key"] = "rank"
    cell.limits = limits
    return cell


def load(path: Path) -> dict:
    return json.loads(path.read_text())
