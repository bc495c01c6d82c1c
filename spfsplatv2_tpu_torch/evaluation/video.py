"""Novel-view trajectory videos from predicted Gaussians (torch port of
`spfsplatv2_tpu/evaluation/video.py`).

The encoder runs on the context views alone, a camera trajectory is
made on the host from the predicted context poses, and every frame of
it is rendered in one `decode_splatting` call (one compositing launch a
frame on the card); the frames are clipped to [0, 1] and, optionally,
written as a GIF.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from spfsplatv2_tpu_torch.models.decoder import DecoderConfig, decode_splatting
from spfsplatv2_tpu_torch.utils.camera_trajectory import (
    generate_wobble,
    generate_wobble_transformation,
    interpolate_extrinsics,
    interpolate_intrinsics,
)
from spfsplatv2_tpu_torch.utils.visualization import save_video

# trajectory_fn(t, context_extrinsics (v, 4, 4), context_intrinsics
# (v, 3, 3)) -> (extrinsics (n, 4, 4), intrinsics (n, 3, 3))
TrajectoryFn = Callable[[np.ndarray, np.ndarray, np.ndarray],
                        tuple[np.ndarray, np.ndarray]]


def _first(x) -> float:
    return float(torch.as_tensor(x).reshape(-1)[0])


@torch.no_grad()
def render_trajectory_video(
    encoder,
    context: dict,
    image_shape: tuple[int, int],
    trajectory_fn: TrajectoryFn,
    num_frames: int = 30,
    smooth: bool = True,
    loop_reverse: bool = True,
    decoder_cfg: DecoderConfig = DecoderConfig(),
    output_path: str | Path | None = None,
    fps: int = 30,
) -> np.ndarray:
    """Render `trajectory_fn`'s cameras on the encoder's device.

    context: one example's (v, ...) arrays or tensors ("image",
    "intrinsics", "near", "far").  Returns (n, h, w, 3) float32 frames,
    n = num_frames, or 2 num_frames - 2 with `loop_reverse`.
    """
    device = next(encoder.parameters()).device
    ctx_img = torch.as_tensor(context["image"], dtype=torch.float32,
                              device=device)[None]
    ctx_k = torch.as_tensor(context["intrinsics"], dtype=torch.float32,
                            device=device)[None]
    out = encoder(ctx_img, ctx_k)

    poses = out["extrinsics_c"][0].cpu().numpy()
    t = np.linspace(0, 1, num_frames, dtype=np.float32)
    if smooth:
        t = (np.cos(np.pi * (t + 1)) + 1) / 2
    trajectory, intr = trajectory_fn(t, poses, ctx_k[0].cpu().numpy())

    v = trajectory.shape[0]
    near = torch.full((1, v), _first(context["near"]), device=device)
    far = torch.full((1, v), _first(context["far"]), device=device)
    rendered = decode_splatting(
        out["gaussians"],
        torch.as_tensor(trajectory, dtype=torch.float32, device=device)[None],
        torch.as_tensor(np.ascontiguousarray(intr), dtype=torch.float32,
                        device=device)[None],
        near, far, image_shape, decoder_cfg,
    )
    frames = torch.clamp(rendered.color[0], 0.0, 1.0).cpu().numpy()
    if loop_reverse:
        frames = np.concatenate([frames, frames[::-1][1:-1]], axis=0)
    if output_path is not None:
        save_video(list(frames), output_path, fps=fps)
    return frames


def render_interpolation_video(
    encoder,
    context: dict,
    image_shape: tuple[int, int],
    num_frames: int = 60,
    decoder_cfg: DecoderConfig = DecoderConfig(),
    output_path: str | Path | None = None,
    fps: int = 30,
) -> np.ndarray:
    """Smooth there-and-back interpolation between the outer context
    poses."""

    def trajectory(t, poses, intrinsics):
        extr = interpolate_extrinsics(poses[0], poses[-1], t)
        intr = interpolate_intrinsics(intrinsics[0], intrinsics[-1], t)
        return extr, intr

    return render_trajectory_video(
        encoder, context, image_shape, trajectory,
        num_frames=num_frames, smooth=True, loop_reverse=True,
        decoder_cfg=decoder_cfg, output_path=output_path, fps=fps,
    )


def render_wobble_video(
    encoder,
    context: dict,
    image_shape: tuple[int, int],
    num_frames: int = 60,
    decoder_cfg: DecoderConfig = DecoderConfig(),
    output_path: str | Path | None = None,
    fps: int = 30,
) -> np.ndarray:
    """Wobble about context view 0 with a radius of 0.25x the context
    separation."""

    def trajectory(t, poses, intrinsics):
        delta = float(np.linalg.norm(poses[0, :3, 3] - poses[-1, :3, 3]))
        extr = generate_wobble(poses[0], delta * 0.25, t)
        intr = np.broadcast_to(intrinsics[0], (t.shape[0], 3, 3))
        return extr, intr

    return render_trajectory_video(
        encoder, context, image_shape, trajectory,
        num_frames=num_frames, smooth=True, loop_reverse=True,
        decoder_cfg=decoder_cfg, output_path=output_path, fps=fps,
    )


def render_exaggerated_interpolation_video(
    encoder,
    context: dict,
    image_shape: tuple[int, int],
    num_frames: int = 300,
    decoder_cfg: DecoderConfig = DecoderConfig(),
    output_path: str | Path | None = None,
    fps: int = 30,
) -> np.ndarray:
    """Extrapolated interpolation (t * 5 - 2) overlaid with a 5-turn
    wobble."""

    def trajectory(t, poses, intrinsics):
        delta = float(np.linalg.norm(poses[0, :3, 3] - poses[-1, :3, 3]))
        tf = generate_wobble_transformation(
            delta * 0.5, t, 5, scale_radius_with_t=False
        )
        extr = interpolate_extrinsics(poses[0], poses[-1], t * 5 - 2)
        intr = interpolate_intrinsics(
            intrinsics[0], intrinsics[-1], t * 5 - 2
        )
        return extr @ tf, intr

    return render_trajectory_video(
        encoder, context, image_shape, trajectory,
        num_frames=num_frames, smooth=False, loop_reverse=False,
        decoder_cfg=decoder_cfg, output_path=output_path, fps=fps,
    )
