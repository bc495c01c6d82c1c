"""In-the-wild demo: photos -> Gaussians -> PLY + interpolation video
(torch port of `spfsplatv2_tpu/demo.py`).

Each image is centre-cropped to a square and resized to the model
resolution; the intrinsics are unit focal with a centred principal
point, near 0.5 and far 100.  The flagship encoder (`SPFSplatV2Config()`,
bf16 backbone) predicts the Gaussians and the context poses; the
Gaussians go to `<output>/gaussians.ply` and a 60-frame there-and-back
interpolation between the outer context poses to
`<output>/interpolation.gif`.

Usage (on the card; `--device cpu` runs the kernels' plain versions):
    python -m spfsplatv2_tpu_torch.demo img1.jpg img2.jpg \
        --checkpoint <step_dir> --output outputs/demo [--image-size 1024]
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from spfsplatv2_tpu_torch.models import build_encoder
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig
from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config, SPFSplatV2Encoder
from spfsplatv2_tpu_torch.ops.raster_tiled import TILE, rank_key_bits


def load_and_prepare(path: str, image_size: int) -> np.ndarray:
    """(image_size, image_size, 3) float32 [0, 1]: the largest centred
    square of the image, resized."""
    from PIL import Image

    from spfsplatv2_tpu_torch.data.shims import rescale_image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    h, w = img.shape[:2]
    side = min(h, w)
    top, left = (h - side) // 2, (w - side) // 2
    img = img[top: top + side, left: left + side]
    return rescale_image(img, (image_size, image_size))


def demo_decoder_config(num_gaussians: int,
                        image_shape: tuple[int, int]) -> DecoderConfig:
    """The JAX demo's `DecoderConfig()` (exact depth rank) wherever the
    rank and the tile id fit the binning's 31-bit key, else the quantized
    depth key (2 views at 1024^2: 21 + 13 bits, where JAX raises)."""
    cfg = DecoderConfig()
    n_tiles = -(-image_shape[0] // TILE) * -(-image_shape[1] // TILE)
    if rank_key_bits(num_gaussians, n_tiles) <= 31:
        return cfg
    return dataclasses.replace(cfg, rasterizer=dataclasses.replace(
        cfg.rasterizer, depth_key="quantized"))


def run_demo(
    image_paths: list[str],
    checkpoint: str | None,
    output: str,
    image_size: int = 256,
    focal: float = 1.0,
    device: str | torch.device = "cuda",
) -> dict:
    """Write `<output>/gaussians.ply` and `<output>/interpolation.gif`;
    returns {"poses": (v, 4, 4) predicted context c2w}."""
    from spfsplatv2_tpu_torch.evaluation.evaluator import disable_tf32
    from spfsplatv2_tpu_torch.evaluation.video import render_interpolation_video
    from spfsplatv2_tpu_torch.utils.ply_export import export_ply

    device = torch.device(device)
    disable_tf32()
    out_dir = Path(output)
    out_dir.mkdir(parents=True, exist_ok=True)

    images = np.stack([load_and_prepare(p, image_size) for p in image_paths])
    v = images.shape[0]
    k = np.asarray([[focal, 0, 0.5], [0, focal, 0.5], [0, 0, 1.0]], np.float32)
    intrinsics = np.tile(k, (v, 1, 1))

    cfg = SPFSplatV2Config()
    if checkpoint:
        from spfsplatv2_tpu_torch.training.loop import load_checkpoint

        with device:
            encoder = SPFSplatV2Encoder(cfg)
        encoder.load_state_dict(load_checkpoint(checkpoint)["encoder"],
                                strict=True)
        encoder.eval()
    else:
        print("WARNING: no checkpoint given; using random initialization")
        encoder = build_encoder(cfg, seed=0, device=device)

    with torch.no_grad():
        out = encoder(torch.as_tensor(images, device=device)[None],
                      torch.as_tensor(intrinsics, device=device)[None])
    g = out["gaussians"].map(lambda x: x[0])
    export_ply(g.means, g.scales, g.rotations, g.harmonics, g.opacities,
               out_dir / "gaussians.ply")
    poses = out["extrinsics_c"][0].cpu().numpy()
    num_gaussians = g.means.shape[0]
    del out, g

    context = {
        "image": images,
        "intrinsics": intrinsics,
        "near": np.full((v,), 0.5, np.float32),
        "far": np.full((v,), 100.0, np.float32),
    }
    shape = (image_size, image_size)
    render_interpolation_video(
        encoder, context, shape,
        decoder_cfg=demo_decoder_config(num_gaussians, shape),
        output_path=out_dir / "interpolation",
    )
    print(f"wrote {out_dir}/gaussians.ply and {out_dir}/interpolation.gif")
    return {"poses": poses}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("images", nargs="+")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--output", default="outputs/demo")
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run_demo(args.images, args.checkpoint, args.output, args.image_size,
             device=args.device)


if __name__ == "__main__":
    main()
