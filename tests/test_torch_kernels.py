"""The port's hand-written CUDA kernels against their plain versions.

The `cuda`-marked tests need an NVIDIA GPU and nvcc and skip without
them.  This file imports torch and the port only (no JAX), so that on a
machine with the card it runs on its own:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spfsplatv2_tpu_torch.ops.attention import (
    flash_attention,
    flash_backward_dkv_cuda,
    flash_backward_dkv_plain,
    flash_backward_dq_cuda,
    flash_backward_dq_plain,
    flash_f32_split_cuda,
    flash_f32_split_forward_cuda,
    flash_f32_split_forward_plain,
    flash_f32_split_plain,
    flash_forward_cuda,
    flash_forward_plain,
    _dense,
)
from spfsplatv2_tpu_torch.ops import cuda_lib
from spfsplatv2_tpu_torch.ops.covariance import build_covariance
from spfsplatv2_tpu_torch.ops.raster_common import project_gaussians
from spfsplatv2_tpu_torch.ops import raster_cuda
from spfsplatv2_tpu_torch.ops.raster_cuda import (
    NUM_FIELDS,
    accumulate_rows,
    composite_backward_cuda,
    composite_backward_plain,
    composite_forward_cuda,
    composite_forward_plain,
)
from spfsplatv2_tpu_torch.ops.raster_tiled import bin_gaussians_prefix
from spfsplatv2_tpu_torch.ops import segscan
from spfsplatv2_tpu_torch.ops.segscan import (
    SCAN_TILE,
    SEG_TILE,
    cumsum_1d_cuda,
    scan_state,
    segmented_scan_lanes_cuda,
    segmented_scan_lanes_plain,
)

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    CAMERA_K,
    adversarial_entries,
    assert_images_close,
    TINY_BACKBONE,
    TINY_HEADS,
    cuda_device,  # noqa: F401  (fixture)
    np_scene,
    to_torch,
)

HW = (48, 48)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on CPU."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        cumsum_1d_cuda(torch.ones(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        composite_forward_cuda(torch.zeros(4, NUM_FIELDS),
                               torch.zeros(8, dtype=torch.int32),
                               torch.zeros(9, dtype=torch.int32),
                               torch.zeros(9, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        composite_backward_cuda(torch.zeros(4, NUM_FIELDS),
                                torch.zeros(8, dtype=torch.int32),
                                torch.zeros(9, dtype=torch.int32),
                                torch.zeros(9, dtype=torch.int32), 3,
                                torch.zeros(9, 256, 8), torch.zeros(9, 256, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        segmented_scan_lanes_cuda(torch.zeros(10, 8),
                                  torch.zeros(8, dtype=torch.int32))
    qkv = [torch.zeros(1, 2, 70, 64, dtype=torch.bfloat16) for _ in range(4)]
    stats = [torch.zeros(1, 2, 70) for _ in range(2)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_forward_cuda(*qkv[:3], 0.125)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_backward_dkv_cuda(*qkv, *stats, 0.125)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_backward_dq_cuda(*qkv, *stats, 0.125)
    f32 = [t.float() for t in qkv[:2]]
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_f32_split_forward_cuda(*f32)


@pytest.mark.parametrize("case", ["bfloat16", "float32", "mixed_dtypes",
                                  "float16", "head_dim_32"])
def test_flash_input_check(case):
    """K5's input check, called directly on CPU tensors: one dtype that a
    kernel takes (bf16 or float32) with head dim 64 passes; mixed dtypes,
    float16 and head dim 32 raise, naming what is wrong."""
    from spfsplatv2_tpu_torch.ops.attention import _check_flash_inputs

    dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
        case, torch.float32)
    d = 32 if case == "head_dim_32" else 64
    tensors = {"q": torch.zeros(2, 3, 70, d, dtype=dtype),
               "k": torch.zeros(2, 3, 90, d, dtype=dtype),
               "v": torch.zeros(2, 3, 90, d, dtype=dtype),
               "do": torch.zeros(2, 3, 70, d, dtype=dtype)}
    if case == "mixed_dtypes":
        tensors["v"] = tensors["v"].to(torch.bfloat16)
    if case in ("bfloat16", "float32"):
        assert _check_flash_inputs(tensors, 70, 90) == 6
        return
    match = {"mixed_dtypes": "v: expected 4-d torch.float32",
             "float16": "bfloat16 or float32, got torch.float16",
             "head_dim_32": "head dim 64, got 32"}[case]
    with pytest.raises(ValueError, match=match):
        _check_flash_inputs(tensors, 70, 90)


def _check_cumsum(x: torch.Tensor) -> None:
    """K3 on x against torch.cumsum: int32 exact; float32 sums in two
    orders, within 1e-5 of the running sum of |x|."""
    got = cumsum_1d_cuda(x)
    want = torch.cumsum(x, 0).to(x.dtype)
    if x.dtype == torch.int32:
        assert torch.equal(got, want), x.shape
    else:
        err = (got - want).abs()
        assert bool((err <= 1e-5 * torch.cumsum(x.abs(), 0) + 1e-6).all())


def _scan_input(rng, n: int, dtype, device) -> torch.Tensor:
    x = (rng.integers(-3, 9, n).astype(np.int32) if dtype == torch.int32
         else rng.uniform(-1, 1, n).astype(np.float32))
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n", [1, 1024, 4099, SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1, 131072,
          1 << 21, (1 << 21) + 1])
def test_cumsum_kernel_matches_plain(cuda_device, n):
    """K3 at both sides of its 8192-element tile, at the 256^2 path's n,
    and at 2^21 (+ 1): 256 tiles, so look-backs span more than one window
    of 32 status words."""
    rng = np.random.default_rng(n)
    for dtype in (torch.int32, torch.float32):
        _check_cumsum(_scan_input(rng, n, dtype, cuda_device))


@pytest.mark.cuda
def test_cumsum_back_to_back_calls(cuda_device):
    """50 calls of mixed type and length on one stream, with no
    synchronisation between them: each call's status words carry its own
    epoch, so no word of an earlier call is taken for one of this call."""
    rng = np.random.default_rng(7)
    xs = [_scan_input(rng, int(n), dtype, cuda_device) for n, dtype in zip(
        rng.integers(1, 300_000, 50),
        [torch.int32, torch.float32] * 25)]
    outs = [cumsum_1d_cuda(x) for x in xs]
    torch.cuda.synchronize()
    for x, got in zip(xs, outs):
        want = torch.cumsum(x, 0).to(x.dtype)
        if x.dtype == torch.int32:
            assert torch.equal(got, want)
        else:
            err = (got - want).abs()
            assert bool((err <= 1e-5 * torch.cumsum(x.abs(), 0) + 1e-6).all())


@pytest.mark.cuda
def test_cumsum_on_two_streams(cuda_device):
    """Calls on two streams at once each take their stream's status
    words."""
    rng = np.random.default_rng(8)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    xs = [_scan_input(rng, 1 << 20, torch.int32, cuda_device)
          for _ in range(8)]
    torch.cuda.synchronize()
    outs = []
    for i, x in enumerate(xs):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(cumsum_1d_cuda(x))
    torch.cuda.synchronize()
    for x, got in zip(xs, outs):
        assert torch.equal(got, torch.cumsum(x, 0).to(torch.int32))


def test_scan_state_epochs(monkeypatch):
    """K3's status-word bookkeeping: each call on a device and stream
    gets a new epoch from 2 up, a longer input a larger (zeroed) buffer,
    the wrap of the epochs a zeroed buffer; under graph capture, whose
    replays would repeat an epoch, it raises and keeps no state."""
    monkeypatch.setattr(segscan, "_scan_state", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    dev = torch.device("cpu")
    words, epoch = scan_state(dev, 1, 1000)
    assert epoch == 2 and words.numel() >= 1
    assert scan_state(dev, 1, 1000)[1] == 3
    assert scan_state(dev, 2, 1000)[1] == 2  # another stream
    words[:] = 5
    big, epoch = scan_state(dev, 1, 300 * SCAN_TILE)
    assert big.numel() >= 300 and int(big.abs().sum()) == 0 and epoch == 2
    segscan._scan_state[None, 1][1] = segscan._EPOCH_LIMIT - 1
    big[:] = 5
    same, epoch = scan_state(dev, 1, 10)
    assert same is big and epoch == 2 and int(big.abs().sum()) == 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="captured"):
        scan_state(dev, 3, 10)
    assert (None, 3) not in segscan._scan_state


@pytest.mark.cuda
@pytest.mark.parametrize("base,cov_scale", [(None, 1.0), (2, 4.0)])
def test_composite_kernel_matches_plain(cuda_device, base, cov_scale):
    means, scales, quats, harm, op = map(
        lambda a: to_torch(a).to(cuda_device), np_scene(0, 300, cov_scale=cov_scale))
    covs = build_covariance(scales, quats)
    proj = project_gaussians(means, covs, harm, op, torch.eye(4, device=cuda_device),
                             to_torch(CAMERA_K).to(cuda_device), HW)
    bins = bin_gaussians_prefix(proj, HW, 32, 64, 300 * 32,
                                base_tiles_per_gaussian=base)
    depth = torch.where(torch.isfinite(proj.depth), proj.depth, 0.0)
    packed = torch.cat([proj.xy, proj.conic, proj.color, proj.opacity[:, None],
                        depth[:, None]], -1).contiguous()
    args = (packed, bins.src, bins.counts, bins.starts, bins.num_tiles_xy[1])
    out = composite_forward_cuda(*args)
    torch.cuda.synchronize()
    plain = composite_forward_plain(*args)
    for sl, atol, hard in ((slice(0, 3), 3e-5, 5e-3), (slice(3, 4), 3e-4, 2e-2),
                           (slice(4, 6), 3e-5, 5e-3)):
        assert_images_close(out[..., sl].cpu(), plain[..., sl].cpu(),
                            atol=atol, hard_atol=hard)
    assert float(out[..., 6:].abs().max()) == 0.0


def _scene_bins(device, base, cov_scale, n=300):
    means, scales, quats, harm, op = map(
        lambda a: to_torch(a).to(device), np_scene(0, n, cov_scale=cov_scale))
    covs = build_covariance(scales, quats)
    proj = project_gaussians(means, covs, harm, op, torch.eye(4, device=device),
                             to_torch(CAMERA_K).to(device), HW)
    bins = bin_gaussians_prefix(proj, HW, 32, 64, n * 32,
                                base_tiles_per_gaussian=base)
    depth = torch.where(torch.isfinite(proj.depth), proj.depth, 0.0)
    packed = torch.cat([proj.xy, proj.conic, proj.color, proj.opacity[:, None],
                        depth[:, None]], -1).contiguous()
    return packed, bins


@pytest.mark.cuda
@pytest.mark.parametrize("base,cov_scale", [(None, 1.0), (2, 4.0)])
def test_composite_backward_kernel_matches_plain(cuda_device, base, cov_scale):
    packed, bins = _scene_bins(cuda_device, base, cov_scale)
    args = (packed, bins.src, bins.counts, bins.starts, bins.num_tiles_xy[1])
    out = composite_forward_cuda(*args)
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal(
        out.shape).astype(np.float32)).to(cuda_device)
    rows = composite_backward_cuda(*args, out, cot)
    torch.cuda.synchronize()
    plain = composite_backward_plain(*args, out, cot)
    # Per entry: 1e-4 of each field's max, with at most 0.1% of the rows
    # off (a pixel whose stop flips between the sequential and the
    # cumulative-product transmittance).
    bad = ((rows - plain).abs() > 1e-4 * plain.abs().amax(0)).any(-1)
    assert int(bad.sum()) <= max(1, int(1e-3 * int(bins.n_live)))
    assert float(rows[int(bins.n_live):].abs().max()) == 0.0
    g = packed.shape[0]
    ours, ref = accumulate_rows(rows, bins, g), accumulate_rows(plain, bins, g)
    assert torch.allclose(ours, ref, atol=2e-3 * float(ref.abs().max()))


def _tile_rows(rng, local, tile, tiles_x):
    """Packed rows (k, 10) in tile `tile` from tile-local columns (mx, my,
    a, b, c, op), with seeded colors and depths."""
    mx, my, a, b, c, op = local
    k = mx.shape[0]
    ox, oy = (tile % tiles_x) * 16, (tile // tiles_x) * 16
    return np.stack([mx + ox, my + oy, a, b, c, *rng.uniform(0, 1, (3, k)),
                     op, rng.uniform(1, 5, k)], -1).astype(np.float32)


def _manual_bins(rows_per_tile, device):
    """Kernel inputs for hand-made tiles: `rows_per_tile` lists each tile's
    rows (k_t, 10) in walk order; src is the identity over their slots."""
    packed = np.concatenate(rows_per_tile)
    counts = np.asarray([r.shape[0] for r in rows_per_tile], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    src = np.arange(packed.shape[0], dtype=np.int32)
    return [torch.from_numpy(x).to(device) for x in (packed, src, counts,
                                                     starts)]


def _check_composite_pair(args, device):
    """K1 against its plain version, K2 against its plain version (rows),
    and K2 rerun bit for bit."""
    out = composite_forward_cuda(*args)
    torch.cuda.synchronize()
    plain = composite_forward_plain(*args)
    for sl, atol, hard in ((slice(0, 3), 3e-5, 5e-3), (slice(3, 4), 3e-4, 2e-2),
                           (slice(4, 6), 3e-5, 5e-3)):
        assert_images_close(out[..., sl].cpu(), plain[..., sl].cpu(),
                            atol=atol, hard_atol=hard)
    assert float(out[..., 6:].abs().max()) == 0.0
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal(
        out.shape).astype(np.float32)).to(device)
    rows = composite_backward_cuda(*args, out, cot)
    again = composite_backward_cuda(*args, out, cot)
    torch.cuda.synchronize()
    assert torch.equal(rows, again)
    want = composite_backward_plain(*args, out, cot)
    n_live = int(args[2].sum())
    bad = ((rows - want).abs() > 1e-4 * want.abs().amax(0)).any(-1)
    assert int(bad.sum()) <= max(1, int(1e-3 * n_live))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_composite_kernels_on_adversarial_entries(cuda_device, seed):
    """K1 and K2 on tiles of entries that stress the cull: near-singular,
    indefinite and negative conics, opacity at a few ulp of 1/255 and of
    1, means just outside the tile, wide Gaussians; 6 tiles, 2 of them
    empty."""
    rng = np.random.default_rng(seed)
    tiles_x, tiles = 3, []
    for t in range(6):
        if t in (1, 4):
            tiles.append(np.zeros((0, NUM_FIELDS), np.float32))
            continue
        cols = _adversarial(seed * 10 + t, 700)
        order = rng.permutation(cols[0].shape[0])
        tiles.append(_tile_rows(rng, [c[order] for c in cols], t, tiles_x))
    packed, src, counts, starts = _manual_bins(tiles, cuda_device)
    _check_composite_pair((packed, src, counts, starts, tiles_x), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("pad_tiles", [0, 300])
def test_composite_kernels_long_and_stopping_tiles(cuda_device, pad_tiles):
    """A tile of 2500 faint entries (more than one staging batch of either
    size, no pixel stops), an empty tile, and a tile whose top half is
    covered by opaque Gaussians (its upper warps stop early, the lower
    ones never do); `pad_tiles` empty tiles more select the kernels'
    smaller batches."""
    rng = np.random.default_rng(11)
    tiles_x = 3

    def gauss(k, x, y, sigma, op):
        s2 = sigma**2
        return [x.astype(np.float32), y.astype(np.float32),
                np.full(k, 1 / s2, np.float32), np.zeros(k, np.float32),
                np.full(k, 1 / s2, np.float32), np.full(k, op, np.float32)]

    faint = gauss(2500, rng.uniform(-2, 18, 2500), rng.uniform(-2, 18, 2500),
                  1.5, 0.02)
    # Three opaque Gaussians on each pixel of rows 0-3 (none reaches row 8).
    gy, gx = np.mgrid[0:4, 0:16].reshape(2, -1).repeat(3, axis=1)
    opaque = gauss(gx.shape[0], gx, gy, 1.0, 0.99)
    below = gauss(800, rng.uniform(0, 16, 800), rng.uniform(0, 16, 800), 1.5,
                  0.03)
    stop = [np.concatenate([a, b]) for a, b in zip(opaque, below)]
    tiles = [_tile_rows(rng, faint, 0, tiles_x),
             np.zeros((0, NUM_FIELDS), np.float32),
             _tile_rows(rng, stop, 2, tiles_x)]
    tiles += [np.zeros((0, NUM_FIELDS), np.float32)] * pad_tiles
    packed, src, counts, starts = _manual_bins(tiles, cuda_device)
    out = _check_composite_pair((packed, src, counts, starts, tiles_x),
                                cuda_device)
    # Three alpha = 0.99 entries on one pixel take T below 1e-4, so each
    # pixel of rows 0-3 stops (at T_fin <= 0.01); rows 8-15 and the long
    # tile keep T far above 1e-4.
    t_fin = out[2, :, 5].reshape(16, 16)
    assert float(t_fin[:4].max()) <= 0.0101
    assert float(t_fin[8:].min()) > 0.1
    assert float(out[0, :, 5].min()) > 0.1


@pytest.mark.cuda
def test_composite_backward_is_deterministic(cuda_device):
    """K2 reruns give the same bits: no atomics, warp partials summed in
    a fixed order."""
    packed, bins = _scene_bins(cuda_device, 2, 4.0, n=3000)
    args = (packed, bins.src, bins.counts, bins.starts, bins.num_tiles_xy[1])
    out = composite_forward_cuda(*args)
    cot = torch.randn(out.shape, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(0))
    runs = [composite_backward_cuda(*args, out, cot) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def _adversarial(seed, n):
    """Finite adversarial tile-local entries (torch_port_common)."""
    return adversarial_entries(seed, n, finite_only=True)


def _check_segmented_scan(vals, seg):
    """K4 on (vals, seg) against its plain version, within 1e-5 of the
    running sum of |x| (both sum in float32 in different orders)."""
    out = segmented_scan_lanes_cuda(vals, seg)
    torch.cuda.synchronize()
    ref = segmented_scan_lanes_plain(vals, seg)
    scale = segmented_scan_lanes_plain(vals.abs(), seg)
    assert bool(((out - ref).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 1024, 5000, SEG_TILE - 1,
                               SEG_TILE + 1, 2 * SEG_TILE,
                               3 * SEG_TILE + 1, 4 * SEG_TILE - 1, 524416])
def test_segmented_scan_kernel_matches_plain(cuda_device, n):
    """K4 on ten rows with short random segments, at both sides of its
    1024-element tile and one and two tiles on, and at the flagship's
    e_pad = 524416."""
    rng = np.random.default_rng(n)
    vals = torch.from_numpy(rng.standard_normal((10, n)).astype(np.float32))
    seg = torch.from_numpy(np.sort(rng.integers(0, max(n // 4, 1), n))
                           .astype(np.int32))
    _check_segmented_scan(vals.to(cuda_device), seg.to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["one_segment", "three_tile_segments",
                                    "tile_aligned_starts"])
def test_segmented_scan_long_segments(cuda_device, layout):
    """K4 where the look-back must walk: one segment over the whole row
    (33 tiles, more than one window of 32 status words, none with a
    start), segments of 3.5 tiles, and segments that start exactly on a
    tile's first element."""
    n = 33 * SEG_TILE + 5
    rng = np.random.default_rng(11)
    vals = torch.from_numpy(rng.standard_normal((10, n)).astype(np.float32))
    pos = np.arange(n)
    seg = {"one_segment": np.zeros(n),
           "three_tile_segments": pos // (7 * SEG_TILE // 2),
           "tile_aligned_starts": pos // SEG_TILE}[layout]
    _check_segmented_scan(vals.to(cuda_device),
                          torch.from_numpy(seg.astype(np.int32))
                          .to(cuda_device))


@pytest.mark.cuda
def test_segmented_scan_in_cuda_graph(cuda_device):
    """K4 captured in a CUDA graph (its status words are zeroed on the
    stream inside the call, so it needs no host state): each replay on
    new values in the captured input gives the plain result."""
    n = 3 * SEG_TILE + 77
    rng = np.random.default_rng(12)
    vals = torch.zeros((10, n), device=cuda_device)
    seg = torch.from_numpy(np.sort(rng.integers(0, n // 50, n)).astype(
        np.int32)).to(cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        segmented_scan_lanes_cuda(vals, seg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = segmented_scan_lanes_cuda(vals, seg)
    for _ in range(3):
        vals.copy_(torch.from_numpy(
            rng.standard_normal((10, n)).astype(np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        ref = segmented_scan_lanes_plain(vals, seg)
        scale = segmented_scan_lanes_plain(vals.abs(), seg)
        assert bool(((out - ref).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
def test_segscan_accumulation_equals_segsum_on_card(cuda_device, monkeypatch):
    packed, bins = _scene_bins(cuda_device, 2, 4.0)
    rows = torch.randn((bins.e_pad, NUM_FIELDS), device=cuda_device)
    rows[int(bins.n_live):] = 0.0
    sums = {}
    for mode in ("segsum", "segscan"):
        monkeypatch.setattr(raster_cuda, "ACCUM_MODE", mode)
        sums[mode] = accumulate_rows(rows, bins, packed.shape[0])
    torch.testing.assert_close(sums["segscan"], sums["segsum"], rtol=1e-5,
                               atol=1e-5)


def _flash_inputs(device, b, h, n_q, n_k, seed=0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    make = lambda n: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, h, n, 64)).astype(np.float32)).to(
            device, dtype)
    return make(n_q), make(n_k), make(n_k), make(n_q)


def _within(actual, desired, frac):
    """max |actual - desired| <= frac * max |desired| (float32)."""
    actual, desired = actual.detach().float(), desired.detach().float()
    return float((actual - desired).abs().max()) <= frac * float(
        desired.abs().max())


# Kernel against plain version, as fractions of max |plain|: O, lse, the
# gradients, and the gradients' absolute bar with one key (below).  bf16:
# both round P (and dS) to bf16 and O to bf16.  float32: nothing is
# rounded; only the order of float32 sums differs.
FLASH_TOLS = {torch.bfloat16: (1e-2, 1e-4, 1e-2, 1e-3),
              torch.float32: (2e-5, 2e-5, 1e-4, 1e-4)}


def _check_flash_kernels(device, b, h, n_q, n_k, dtype=torch.bfloat16):
    o_tol, lse_tol, grad_tol, one_key_atol = FLASH_TOLS[dtype]
    q, k, v, do = _flash_inputs(device, b, h, n_q, n_k, dtype=dtype)
    scale = 0.125
    o, lse = flash_forward_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    o_p, lse_p = flash_forward_plain(q, k, v, scale)
    assert o.dtype == dtype
    assert _within(o, o_p, o_tol)
    assert float((lse - lse_p).abs().max()) <= lse_tol * float(
        lse_p.abs().max())
    di = (do.float() * o.float()).sum(-1)
    dk, dv = flash_backward_dkv_cuda(q, k, v, do, lse, di, scale)
    dq = flash_backward_dq_cuda(q, k, v, do, lse, di, scale)
    torch.cuda.synchronize()
    dk_p, dv_p = flash_backward_dkv_plain(q, k, v, do, lse, di, scale)
    dq_p = flash_backward_dq_plain(q, k, v, do, lse, di, scale)
    for name, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p),
                            ("dv", dv, dv_p)):
        assert got.dtype == dtype and bool(torch.isfinite(got).all()), name
        if n_k == 1 and name != "dv":
            err = float((got.float() - want.float()).abs().max())
            assert err <= one_key_atol, (name, err)
        else:
            assert _within(got, want, grad_tol), name


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n_k",
                         [(4098, 4098), (300, 389), (100, 7), (64, 1),
                          (192, 320), (130, 4098), (4098, 63),
                          (127, 4098), (129, 4098), (191, 4098), (193, 4098),
                          (383, 4098), (385, 4098), (4098, 127), (4098, 129),
                          (4098, 255), (4098, 257)])
def test_flash_kernels_match_plain(cuda_device, n_q, n_k):
    """K5's three kernels against their plain versions at ragged lengths
    (fewer keys than one tile included): O within 1e-2 of max |O| (bf16
    output, P rounded to bf16 in both) and lse within 1e-4; dQ, dK, dV
    within 1e-2 of their max.  The backward kernels take 128-row key
    (dK/dV) and query (dQ) tiles and stream 64-row tiles of the other
    axis: (192, 320), (130, 4098) and (4098, 63) end both on part of a
    tile.  The forward takes 192 query rows a CTA (64 a warpgroup) and
    128-key tiles: (127-385, 4098) sit at both sides of two warpgroups,
    one and two CTAs, (4098, 127-257) at both sides of one and two key
    tiles.
    With one key, P = 1 and dS = P (dP - di) is zero up to the
    rounding of two float32 sums in different orders, so dQ and dK are
    zero up to rounding: a bar relative to their max means nothing
    there, and they are held within 1e-3 absolute."""
    _check_flash_kernels(cuda_device, 1, 3, n_q, n_k)


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n_k",
                         [(4098, 4098), (4096, 4096), (300, 389), (100, 7),
                          (64, 1), (63, 65), (65, 63), (130, 4098),
                          (4098, 127), (4098, 129), (31, 389), (32, 389),
                          (33, 389), (300, 31), (300, 32), (300, 33),
                          (127, 300), (129, 300), (128, 64), (255, 300),
                          (257, 300), (300, 191), (300, 193)])
def test_flash_f32_kernels_match_plain(cuda_device, n_q, n_k):
    """K5's float32 kernels (csrc/flash_f32_*.cu) against their plain
    versions at ragged lengths: O and lse within 2e-5 of their max, dQ,
    dK and dV within 1e-4 (the 3xTF32 products keep float32 accuracy;
    float32 sums in another order).  The forward takes 128 query rows a
    CTA (64 a warpgroup) and 64-key tiles; the dK/dV kernel 128 keys a
    CTA (64 a warpgroup) and 32-query tiles; the dQ kernel 128 query rows
    a CTA (64 a warpgroup) and 32-key tiles: (63, 65), (65, 63), (4098,
    127-129), n_q of 31-33, 127-129 and 255-257, n_k of 31-33 and 191-193
    end at both sides of a tile, (128, 64) on one; with one key dQ and dK
    are zero up to rounding and held within 1e-4 absolute."""
    _check_flash_kernels(cuda_device, 1, 3, n_q, n_k, torch.float32)


@pytest.mark.cuda
def test_flash_f32_kernels_across_heads_and_scales(cuda_device):
    """b x h = 6 heads of 4098 rows (each head's last tile reads past its
    rows: zeros, never the next head's), then a negative and a zero
    scale, which flash_forward_cuda folds into q."""
    _check_flash_kernels(cuda_device, 2, 3, 4098, 4098, torch.float32)
    q, k, v, _ = _flash_inputs(cuda_device, 1, 3, 300, 389, seed=4,
                               dtype=torch.float32)
    for scale in (-0.125, 0.0):
        o, lse = flash_forward_cuda(q, k, v, scale)
        torch.cuda.synchronize()
        o_p, lse_p = flash_forward_plain(q, k, v, scale)
        assert _within(o, o_p, 2e-5)
        assert float((lse - lse_p).abs().max()) <= 2e-5 * float(
            lse_p.abs().max())


@pytest.mark.cuda
def test_flash_f32_forward_is_deterministic(cuda_device):
    """The float32 forward writes each row once and sums its key tiles in
    a fixed order: two launches (each with its split pre-pass) on the same
    inputs give the same bits of O and lse."""
    q, k, v, _ = _flash_inputs(cuda_device, 2, 3, 4098, 4098, seed=3,
                               dtype=torch.float32)
    runs = [flash_forward_cuda(q, k, v, 0.125) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_flash_f32_backward_is_deterministic(cuda_device):
    """The float32 backward pair writes each output row once, with no
    atomics, and sums its tiles in a fixed order: two launches of each
    kernel (and of the split pre-pass) on the same inputs give the same
    bits."""
    q, k, v, do = _flash_inputs(cuda_device, 2, 3, 4098, 4098, seed=2,
                                dtype=torch.float32)
    o, lse = flash_forward_cuda(q, k, v, 0.125)
    di = (do * o).sum(-1)
    args = (q, k, v, do, lse, di, 0.125)
    splits = [flash_f32_split_cuda(q, k, v, do) for _ in range(2)]
    runs = [(*flash_backward_dkv_cuda(*args, split=sp),
             flash_backward_dq_cuda(*args, split=sp)) for sp in splits]
    torch.cuda.synchronize()
    for name in splits[0]:
        assert torch.equal(splits[0][name], splits[1][name]), name
    for name, first, second in zip(("dk", "dv", "dq"), *runs):
        assert torch.equal(first, second), name


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n_k", [(4098, 4098), (300, 389), (5, 13),
                                     (64, 1)])
def test_flash_f32_split_matches_plain(cuda_device, n_q, n_k):
    """The split pre-passes (csrc/flash_f32_split.cu) write bit for bit
    what their plain versions compute: the backward's, the hi and lo tf32
    planes of q, k, v and dO as they lie, and those of q, k and dO
    transposed, padded with zeros to a multiple of 8 rows and permuted
    inside each group of 8; the forward's, those of k as it lies and of v
    transposed.  Each counts one launch."""
    q, k, v, do = _flash_inputs(cuda_device, 2, 3, n_q, n_k, seed=5,
                                dtype=torch.float32)
    cuda_lib.reset_launch_counts()
    got = flash_f32_split_cuda(q, k, v, do)
    got_fwd = flash_f32_split_forward_cuda(k, v)
    assert cuda_lib.launch_counts["flash_f32_split"] == 1
    assert cuda_lib.launch_counts["flash_f32_split_forward"] == 1
    torch.cuda.synchronize()
    for got, want in ((got, flash_f32_split_plain(q, k, v, do)),
                      (got_fwd, flash_f32_split_forward_plain(k, v))):
        assert sorted(got) == sorted(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2],
                         ids=["a_shared-k64-n32", "a_accumulator-k32-n64",
                              "a_registers-k64-n32"])
def test_wgmma_tf32_product_matches_float64(cuda_device, mode):
    """Each kind of 3xTF32 product of K5's float32 backward alone
    (csrc/wgmma_tf32_check.cu): A from shared memory over both 128-byte
    halves of a 256-byte row (dP^T, S, dP); A from an m64n32
    accumulator's registers with the k axis permuted and B the split
    pre-pass's transposed planes (dV, dK, dQ); A loaded into registers
    from its planes in device memory (S^T, with K in registers); against
    a float64 matmul of the same float32 inputs.  Three passes must keep
    float32 accuracy: within 1e-5 of max (a k-term float32 sum errs
    ~k * 2^-24 ~ 4e-6 of max at worst; a wrong descriptor, half offset,
    fragment order or permutation errs by the order of max).  One pass
    (hi * hi) keeps 10 mantissa bits and must err at least 10x more:
    that is why three are needed."""
    rng = np.random.default_rng(20 + mode)
    make = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
    if mode == 1:
        a, x = make(64, 32), make(32, 64)
        ref = a.double() @ x.double()
        a_in = a
        b_in = flash_f32_split_plain(*[x[None, None]] * 4)["k_t"][:, 0]
    else:
        a, bt = make(64, 64), make(32, 64)
        ref = a.double() @ bt.double().T
        a_in = flash_f32_split_plain(*[a[None, None]] * 4)["k_hl"][:, 0]
        b_in = flash_f32_split_plain(*[bt[None, None]] * 4)["k_hl"][:, 0]
    a_in, b_in = a_in.contiguous(), b_in.contiguous()
    errs = {}
    for passes in (3, 1):
        c = torch.empty(ref.shape, device=cuda_device)
        err = cuda_lib.library("wgmma_tf32_check").spf_wgmma_tf32_check(
            a_in.data_ptr(), b_in.data_ptr(), c.data_ptr(), mode, passes,
            cuda_lib.stream_handle(cuda_device))
        cuda_lib.check(err, "wgmma_tf32_check")
        torch.cuda.synchronize()
        errs[passes] = float((c.double() - ref).abs().max() / ref.abs().max())
    assert errs[3] <= 1e-5, errs
    assert errs[1] >= 10 * errs[3], errs


@pytest.mark.cuda
def test_flash_kernels_match_plain_across_heads(cuda_device):
    """b x h = 6 heads of 4098 rows: every tail tile reaches past its
    head's last row, where a 2-D tensor map over (64, b*h*n) would read
    the next head's rows; the 3-D maps read zeros there."""
    _check_flash_kernels(cuda_device, 2, 3, 4098, 4098)


@pytest.mark.cuda
def test_flash_backward_is_deterministic(cuda_device):
    """Each output tile is written once, with no atomics: two runs of
    the forward and of each backward kernel give the same bits."""
    q, k, v, do = _flash_inputs(cuda_device, 2, 3, 4098, 4098, seed=2)
    forward = [flash_forward_cuda(q, k, v, 0.125) for _ in range(2)]
    o, lse = forward[0]
    di = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, di, 0.125)
    runs = [(*fwd, *flash_backward_dkv_cuda(*args),
             flash_backward_dq_cuda(*args)) for fwd in forward]
    torch.cuda.synchronize()
    for name, first, second in zip(("o", "lse", "dk", "dv", "dq"), *runs):
        assert torch.equal(first, second), name


@pytest.mark.cuda
def test_flash_forward_peaked_logits(cuda_device):
    """Logits whose row max rises from one key tile to the next (q
    scaled by 4, the keys of tile j by 1 + j / 4, ~4 log2 units a tile):
    O and l are rescaled whenever a row's max has risen past the kernel's
    threshold of 2^8 and carried on the old max between.  O within 1e-2
    of max |O|, lse within 1e-4 of max |lse|, against the plain
    version."""
    q, k, v, _ = _flash_inputs(cuda_device, 1, 3, 1000, 1030, seed=3)
    q = (q.float() * 4).to(torch.bfloat16)
    tile = torch.arange(1030, device=cuda_device).div(128,
                                                      rounding_mode="floor")
    k = (k.float() * (1 + tile[:, None] / 4)).to(torch.bfloat16)
    o, lse = flash_forward_cuda(q, k, v, 0.125)
    torch.cuda.synchronize()
    o_p, lse_p = flash_forward_plain(q, k, v, 0.125)
    assert _within(o, o_p, 1e-2)
    assert float((lse - lse_p).abs().max()) <= 1e-4 * float(lse_p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_flash_forward_takes_any_scale(cuda_device, scale):
    """The kernel takes the row max over the raw logits, so it takes a
    positive scale only; flash_forward_cuda folds a negative or zero one
    into q.  O within 1e-2 of max |O|, lse within 1e-4 of max |lse|
    against the plain version."""
    q, k, v, _ = _flash_inputs(cuda_device, 1, 3, 300, 389, seed=4)
    o, lse = flash_forward_cuda(q, k, v, scale)
    torch.cuda.synchronize()
    o_p, lse_p = flash_forward_plain(q, k, v, scale)
    assert _within(o, o_p, 1e-2)
    assert float((lse - lse_p).abs().max()) <= 1e-4 * float(lse_p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "a_regs,b_mn_major,n",
    [(0, 0, 64), (0, 1, 64), (1, 0, 64), (1, 1, 64), (0, 0, 128)],
    ids=["a_shared-b_k_major", "a_shared-b_mn_major", "a_registers-b_k_major",
         "a_registers-b_mn_major", "a_shared-b_k_major-n128"])
def test_wgmma_product_matches_matmul(cuda_device, a_regs, b_mn_major, n):
    """Each kind of wgmma product of K5's backward kernels alone
    (csrc/wgmma_check.cu: TMA over 3-D maps with the 128-byte swizzle,
    two warpgroups of 64 rows, four k16 steps; n = 128 is the dQ kernel's
    m64n128 S and dP) against torch.matmul in float32: the bf16 products
    are exact in float32, so only the order of the 64-term sums differs
    (within 1e-4 of max).  A wrong descriptor stride, k16 step or
    transpose bit gives errors of the order of max."""
    rng = np.random.default_rng(10 + 2 * a_regs + b_mn_major + n)
    make = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(
            cuda_device, torch.bfloat16)
    a, b = make(128, 64), make(64, n)
    stored = b if b_mn_major else b.T.contiguous()
    c = torch.empty(128, n, device=cuda_device)
    err = cuda_lib.library("wgmma_check").spf_wgmma_check(
        a.data_ptr(), stored.data_ptr(), c.data_ptr(), n, a_regs, b_mn_major,
        cuda_lib.stream_handle(cuda_device))
    cuda_lib.check(err, "wgmma_check")
    torch.cuda.synchronize()
    ref = a.float() @ b.float()
    worst = float((c - ref).abs().max())
    assert worst <= 1e-4 * float(ref.abs().max()), worst


@pytest.mark.cuda
def test_flash_attention_autograd_matches_dense(cuda_device):
    """The autograd function (K5 forward, dK/dV and dQ kernels) against
    autograd through the dense form in float32 on the same bf16 inputs,
    within 2e-2 of each max (the kernels round P and dS to bf16)."""
    q, k, v, do = _flash_inputs(cuda_device, 2, 2, 4098, 4098, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    cuda_lib.reset_launch_counts()
    out = flash_attention(*leaves, 0.125)
    grads = torch.autograd.grad(out, leaves, do)
    counts = {n: cuda_lib.launch_counts[n] for n in
              ("flash_forward", "flash_backward_dkv", "flash_backward_dq")}
    assert counts == {"flash_forward": 1, "flash_backward_dkv": 1,
                      "flash_backward_dq": 1}
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = _dense(*ref_leaves, 0.125)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do.float())
    assert _within(out, ref, 2e-2)
    for got, want in zip(grads, ref_grads):
        assert _within(got, want, 2e-2)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*[t[..., :32].contiguous() for t in (q, k, v)], 0.125)


@pytest.mark.cuda
def test_flash_f32_autograd_matches_dense(cuda_device):
    """The autograd function on float32 inputs launches the three float32
    kernels and the forward's and the backward's split pre-passes once
    each (and no bf16 one) and matches autograd through the
    dense form in float32 within 1e-4 of each max; mixed dtypes raise."""
    q, k, v, do = _flash_inputs(cuda_device, 2, 2, 4098, 4098, seed=1,
                                dtype=torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    cuda_lib.reset_launch_counts()
    out = flash_attention(*leaves, 0.125)
    grads = torch.autograd.grad(out, leaves, do)
    counts = {n: c for n, c in cuda_lib.launch_counts.items()
              if n.startswith("flash")}
    assert counts == {"flash_forward": 0, "flash_backward_dkv": 0,
                      "flash_backward_dq": 0, "flash_f32_forward": 1,
                      "flash_f32_split_forward": 1,
                      "flash_f32_split": 1, "flash_f32_backward_dkv": 1,
                      "flash_f32_backward_dq": 1}
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = _dense(*ref_leaves, 0.125)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do)
    assert _within(out, ref, 1e-4)
    for got, want in zip(grads, ref_grads):
        assert _within(got, want, 1e-4)
    with pytest.raises(ValueError, match="as q"):
        flash_attention(q, k.to(torch.bfloat16), v, 0.125)


@pytest.mark.cuda
def test_memory_guard_probe_moves_nothing_on_the_card(cuda_device):
    """`training/loop.py:probe_peak_gb` reads a peak and changes no
    parameter, gradient, moment, count or RNG state."""
    from spfsplatv2_tpu_torch.config import load_config
    from spfsplatv2_tpu_torch.models.croco.backbone import CrocoBackboneConfig
    from spfsplatv2_tpu_torch.models import build_encoder
    from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config
    from spfsplatv2_tpu_torch.training import loop
    from spfsplatv2_tpu_torch.training.optim import Optimizer, OptimizerConfig
    from spfsplatv2_tpu_torch.training.step import LossConfig, init_train_state

    enc = build_encoder(SPFSplatV2Config(
        backbone=CrocoBackboneConfig(**TINY_BACKBONE), **TINY_HEADS),
        device=cuda_device)
    state = init_train_state(enc, Optimizer(OptimizerConfig(),
                                            enc.named_parameters()))
    gen = torch.Generator().manual_seed(0)
    for p in state.optimizer.params:
        p.grad = (1e-3 * torch.randn(p.shape, generator=gen)).to(cuda_device)
    state.optimizer.step()
    state.step += 1
    before = [p.detach().clone() for p in state.encoder.parameters()]
    counts = (state.step, state.optimizer.count, state.optimizer.skipped_count)
    moments = [t.clone() for t in loop.checkpoint_dict(state)["mu"].values()]
    rng_state = torch.cuda.get_rng_state(cuda_device)
    rng = np.random.default_rng(0)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]])

    def side(v):
        return {"image": torch.as_tensor(rng.uniform(0, 1, (2, v, 32, 32, 3)),
                                         dtype=torch.float32),
                "intrinsics": k.expand(2, v, 3, 3).clone(),
                "near": torch.ones(2, v), "far": torch.full((2, v), 100.0)}

    batch = loop.to_device({"context": side(2), "target": side(1)}, cuda_device)
    peak = loop.probe_peak_gb(state, batch, 1, dict(
        image_shape=(32, 32), decoder_cfg=load_config().decoder,
        loss_cfg=LossConfig(use_lpips=False), lpips=None,
        training_context=False))
    assert 0 < peak < 80
    assert all(torch.equal(a, p) for a, p in zip(before,
                                                 state.encoder.parameters()))
    assert all(p.grad is None for p in state.encoder.parameters())
    assert (state.step, state.optimizer.count,
            state.optimizer.skipped_count) == counts
    assert all(torch.equal(a, b) for a, b in zip(
        moments, loop.checkpoint_dict(state)["mu"].values()))
    assert torch.equal(rng_state, torch.cuda.get_rng_state(cuda_device))


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, imports in a process
    where jax, flax and the JAX package cannot be imported; the config
    (YAML presets included) needs no PyYAML."""
    import subprocess
    import textwrap

    repo = Path(__file__).resolve().parents[1]
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(repo)!r})
        BLOCKED = ("jax", "jaxlib", "flax", "spfsplatv2_tpu")
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import spfsplatv2_tpu_torch.config
        assert "yaml" not in sys.modules
        import spfsplatv2_tpu_torch
        for m in pkgutil.walk_packages(spfsplatv2_tpu_torch.__path__,
                                       "spfsplatv2_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        for name in ("spfsplatv2_tpu_torch.ops.attention",
                     "spfsplatv2_tpu_torch.training.step",
                     "spfsplatv2_tpu_torch.training.optim",
                     "spfsplatv2_tpu_torch.losses.lpips",
                     "spfsplatv2_tpu_torch.losses.reproj",
                     "spfsplatv2_tpu_torch.losses.mse",
                     "spfsplatv2_tpu_torch.evaluation.pose_align",
                     "spfsplatv2_tpu_torch.utils.init",
                     "spfsplatv2_tpu_torch.config",
                     "spfsplatv2_tpu_torch.main",
                     "spfsplatv2_tpu_torch.data.chunk_io",
                     "spfsplatv2_tpu_torch.data.dataset",
                     "spfsplatv2_tpu_torch.data.shims",
                     "spfsplatv2_tpu_torch.data.synthetic",
                     "spfsplatv2_tpu_torch.data.view_samplers",
                     "spfsplatv2_tpu_torch.training.loop",
                     "spfsplatv2_tpu_torch.training.validation",
                     "spfsplatv2_tpu_torch.evaluation.pose_evaluator",
                     "spfsplatv2_tpu_torch.utils.pnp",
                     "spfsplatv2_tpu_torch.utils.yaml_lite",
                     "spfsplatv2_tpu_torch.demo",
                     "spfsplatv2_tpu_torch.evaluation.video",
                     "spfsplatv2_tpu_torch.evaluation.metric_computer",
                     "spfsplatv2_tpu_torch.evaluation.index_generator",
                     "spfsplatv2_tpu_torch.geometry.projection",
                     "spfsplatv2_tpu_torch.utils.camera_trajectory",
                     "spfsplatv2_tpu_torch.utils.ply_export",
                     "spfsplatv2_tpu_torch.parallel.mesh",
                     "spfsplatv2_tpu_torch.parallel.raster_shard",
                     "spfsplatv2_tpu_torch.utils.drawing",
                     "spfsplatv2_tpu_torch.utils.logger",
                     "spfsplatv2_tpu_torch.utils.profiling",
                     "spfsplatv2_tpu_torch.data.convert_dl3dv",
                     "spfsplatv2_tpu_torch.overfit"):
            assert name in sys.modules, name
        print("imported", len(sys.modules))
    """)
    proc = subprocess.run([sys.executable, "-I", "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout
