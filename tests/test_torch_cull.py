"""The compositing kernels' cull and the encoder's check of K5's limits.

`raster_cuda.cull_box_plain` is the cull box of `csrc/composite_common.cuh`
(same formula, same margins): K1 and K2 walk an entry only at the pixels
of its box, so every pixel that the exact float32 skip test of
`entry_alpha` keeps must lie inside it.  These tests hold it against that
test, evaluated in the kernels' operation order, on seeded adversarial
entries.  No JAX here: the predicate has no counterpart in the JAX package.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spfsplatv2_tpu_torch.ops import attention
from spfsplatv2_tpu_torch.ops.raster_common import ALPHA_MAX, ALPHA_MIN
from spfsplatv2_tpu_torch.ops.raster_cuda import cull_box_plain

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import adversarial_entries, conics  # noqa: E402

TILE = 16


def kept(mx, my, a, b, c, op, exp_scale=1.0):
    """(n, 16, 16) pixels of the tile that `entry_alpha` keeps, in its
    order of float32 operations; `exp_scale` moves exp by a few ulp, as
    the card's expf (2 ulp) may."""
    pix = torch.arange(TILE, dtype=torch.float32)
    px = pix[None, None, :]
    py = pix[None, :, None]
    col = lambda v: v[:, None, None]  # noqa: E731
    ddx = px - col(mx)
    ddy = py - col(my)
    quad = (col(a) * ddx) * ddx + (col(c) * ddy) * ddy
    power = (-0.5 * quad) - (col(b) * ddx) * ddy
    alpha = torch.fmin(col(op) * (torch.exp(power) * exp_scale),
                       torch.tensor(ALPHA_MAX))
    return ~(power > 0.0) & ~(alpha < ALPHA_MIN)


def in_box(box):
    x_lo, x_hi, y_lo, y_hi = box
    pix = torch.arange(TILE)
    inside_x = (pix[None, :] >= x_lo[:, None]) & (pix[None, :] <= x_hi[:, None])
    inside_y = (pix[None, :] >= y_lo[:, None]) & (pix[None, :] <= y_hi[:, None])
    return inside_y[:, :, None] & inside_x[:, None, :]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_box_holds_every_kept_pixel(seed):
    """No pixel that the exact skip test keeps (with exp moved by up to
    2^-21 either way) lies outside the entry's cull box."""
    entries = [torch.from_numpy(x) for x in adversarial_entries(seed)]
    box = cull_box_plain(*entries)
    inside = in_box(box)
    for exp_scale in (1.0, 1.0 + 2.0**-21, 1.0 - 2.0**-21):
        outside = kept(*entries, exp_scale=exp_scale) & ~inside
        bad = torch.nonzero(outside.flatten(1).any(1))[:5, 0]
        assert not bool(outside.any()), [
            [float(v[i]) for v in entries] for i in bad]


def test_cull_box_culls():
    """The box is tight where the conic is well conditioned: most pairs
    of pixel-sized Gaussians fall outside it, entries below 1/255 opacity
    get an empty box, and a conic the cull cannot trust keeps the tile."""
    rng = np.random.default_rng(5)
    n = 2000
    a, b, c = conics(rng, n, (-0.3, 0.3), (0, 0.5))
    entries = [torch.from_numpy(x.astype(np.float32)) for x in (
        rng.uniform(0, 16, n), rng.uniform(0, 16, n), a, b, c,
        rng.uniform(0.05, 0.95, n))]
    inside = in_box(cull_box_plain(*entries))
    exact = kept(*entries)
    assert float(inside.float().mean()) < 0.15
    assert int(inside.sum()) < 3 * int(exact.sum())
    one = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    x_lo, x_hi, _, _ = cull_box_plain(one(8.0), one(8.0), one(1.0), one(0.0),
                                      one(1.0), one(0.998 * ALPHA_MIN))
    assert int(x_lo) > int(x_hi)
    for conic in ((1.0, 2.0, 1.0), (-1.0, 0.0, 1.0), (1.0, 0.0, 0.0)):
        box = cull_box_plain(one(8.0), one(8.0), *map(one, conic), one(0.5))
        assert [int(v) for v in box] == [0, 15, 0, 15]


@pytest.mark.parametrize("dtype,head_dim,keys,device,fires", [
    (torch.float16, 64, 4096, "cuda", True),
    (torch.bfloat16, 32, 4096, "cuda", True),
    (torch.float16, 64, 5000, "cuda", True),
    (torch.bfloat16, 64, 4096, "cuda", False),
    (torch.float32, 64, 4095, "cuda", False),
    (torch.float32, 32, 4096, "cpu", False),
    (torch.float32, 64, 4096, "cuda", False),
    (torch.float32, 32, 4096, "cuda", True),
])
def test_flash_limits_check(dtype, head_dim, keys, device, fires):
    """The predicate behind the encoder's check: it names K5's limits for a
    self-attention that would reach K5 on CUDA tensors at FLASH_MIN_KV
    keys or more in a dtype that no K5 kernel takes (float16) or another
    head dim than 64, and is silent for bf16 and float32 with 64-wide
    heads, on CPU and below the threshold."""
    msg = attention.flash_limits_violation(torch.device(device), dtype,
                                           [(keys // 2, head_dim),
                                            (keys, head_dim)])
    assert (msg is not None) == fires
    if fires:
        assert "bfloat16 or float32" in msg and "head dim 64" in msg


class _Computed(Exception):
    pass


@pytest.mark.parametrize("compute_dtype,num_heads,min_kv,raises", [
    ("float16", 2, 4, True), ("float32", 4, 4, True), ("bfloat16", 2, 4, False),
    ("float32", 2, 4, False), ("float32", 4, 7, False)])
def test_encoder_names_k5_limits(monkeypatch, compute_dtype, num_heads, min_kv,
                                 raises):
    """The CroCo backbone raises before any computation when a per-view
    self-attention would hand K5 on CUDA tensors (here pretended: the
    check is told the images lie on "cuda") a dtype that no K5 kernel
    takes (float16) or heads other than 64 wide (128 / 4 = 32); bf16 and
    float32 with 64-wide heads reach the computation.  It reads
    FLASH_MIN_KV at call time, as sdpa does."""
    from spfsplatv2_tpu_torch.models.croco import backbone

    cfg = backbone.CrocoBackboneConfig(
        patch_size=16, enc_depth=1, enc_embed_dim=128, enc_num_heads=num_heads,
        dec_depth=1, dec_embed_dim=128, dec_num_heads=num_heads,
        compute_dtype=compute_dtype)
    model = backbone.MaskedCrocoBackbone(cfg)

    def computed(*args):
        raise _Computed

    real = attention.flash_limits_violation
    monkeypatch.setattr(backbone, "flash_limits_violation",
                        lambda device, *a: real(torch.device("cuda"), *a))
    monkeypatch.setattr(model.patch_embed, "forward", computed)
    monkeypatch.setattr(attention, "FLASH_MIN_KV", min_kv)
    # 2 x 2 patches a view (4 encoder keys), 6 decoder tokens a view.
    images = torch.zeros(1, 2, 32, 32, 3)
    intr = torch.eye(3).expand(1, 2, 3, 3)
    with pytest.raises(ValueError if raises else _Computed) as err:
        model(images, intr, num_target=1)
    if raises:
        assert "compute_dtype" in str(err.value)
        assert "head dim 64" in str(err.value)
