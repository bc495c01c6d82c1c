"""The port's trajectory video renderers vs the JAX package's on the CPU.

The tiny encoder with the same numpy weights encodes one seeded 64 x 64
context pair in both packages; the interpolation, wobble and
exaggerated-interpolation trajectories are rendered and written as GIFs.
Both packages render through their "tiled" backend, JAX's default off
the TPU: at 64^2 it drops thousands of entries a frame past its
`max_per_tile`, where the port's default (the prefix binning, K1's plain
version on the CPU) drops none, so the two defaults differ by design.
JAX's `decode_splatting` renders one camera a call here (`per_camera`):
the same render, compiled once; and its encoder runs with `apply`
jitted (`jitted`) where the video module would apply it op by op (both
in torch_port_common.py).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from spfsplatv2_tpu.evaluation import video as jvideo
from spfsplatv2_tpu.models.decoder import DecoderConfig as JDecoderConfig
from spfsplatv2_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from spfsplatv2_tpu_torch.evaluation import video
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig
from spfsplatv2_tpu_torch.ops import cuda_lib
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    CAMERA_K,
    assert_images_close,
    jax_tiny_encoder,
    jitted,
    per_camera,
    random_flax_params,
    torch_tiny_encoder,
)

HW = (64, 64)
# (renderer, num_frames, frames written): the looped videos add the way
# back without its ends.
RENDERERS = [("render_interpolation_video", 4, 6),
             ("render_wobble_video", 4, 6),
             ("render_exaggerated_interpolation_video", 5, 5)]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[:HW[0], :HW[1]] / HW[0]
    base = np.stack([xx, yy, 0.5 + 0.3 * np.sin(9 * xx * yy)], -1)
    images = np.clip(base[None] + 0.1 * rng.standard_normal((2, *HW, 3)), 0, 1)
    context = {"image": images.astype(np.float32),
               "intrinsics": np.tile(CAMERA_K, (2, 1, 1)),
               "near": np.full((2,), 0.5, np.float32),
               "far": np.full((2,), 100.0, np.float32)}
    jenc = jax_tiny_encoder()
    params = random_flax_params(jenc, 3, context["image"][None],
                                context["intrinsics"][None])
    return context, jenc, params, torch_tiny_encoder(params)


@pytest.mark.parametrize("name,num_frames,written", RENDERERS)
def test_trajectory_video_matches_jax(setup, name, num_frames, written,
                                      tmp_path, monkeypatch):
    context, jenc, params, tenc = setup
    monkeypatch.setattr(jvideo, "decode_splatting",
                        per_camera(jvideo.decode_splatting))
    ref = getattr(jvideo, name)(
        jitted(jenc), params, context, HW, num_frames=num_frames,
        decoder_cfg=JDecoderConfig(rasterizer=JRasterizerConfig(
            backend="tiled", entry_budget_factor=4.0)),
        output_path=tmp_path / "jax.gif")
    cuda_lib.reset_launch_counts()
    ours = getattr(video, name)(
        tenc, context, HW, num_frames=num_frames,
        decoder_cfg=DecoderConfig(rasterizer=RasterizerConfig(
            backend="tiled", entry_budget_factor=4.0)),
        output_path=tmp_path / "torch")
    assert all(v == 0 for v in cuda_lib.launch_counts.values())
    assert ours.shape == ref.shape == (written, *HW, 3)
    assert ours.min() >= 0.0 and ours.max() <= 1.0 and ours.mean() > 0.01
    assert_images_close(ours, ref)
    # The frames move: a trajectory, not one pose.
    assert np.abs(ours[0] - ours[written // 2]).max() > 0.05
    with Image.open(tmp_path / "torch.gif") as ours_gif, \
            Image.open(tmp_path / "jax.gif") as ref_gif:
        assert ours_gif.n_frames == ref_gif.n_frames
        assert ours_gif.size == ref_gif.size == HW[::-1]
        # int(1000 / 30) = 33 ms, stored in centiseconds.
        assert ours_gif.info["duration"] == ref_gif.info["duration"] == 30
        assert ours_gif.info["loop"] == ref_gif.info["loop"] == 0
