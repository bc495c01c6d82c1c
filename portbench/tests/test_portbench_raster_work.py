"""The K1/K2 count of `raster_work.py`: the rows and tile entries that the
walk reaches and the pixel-entry pairs it blends, against a
pixel-by-pixel walk written out here, on scenes small enough for it; the
readers that turn it into a roofline share."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import harness, raster_work, roofline
from portbench import trace as trace_mod
from portbench.reference.ops.raster_common import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    project_gaussians,
)
from portbench.reference.ops.raster_cuda import packed_rows
from portbench.reference.ops.raster_tiled import TILE, bin_gaussians_prefix
from portbench.reference.ops.rasterizer import RasterizerConfig, entry_budget

HW = 48
CFG = RasterizerConfig(entry_budget_factor=4.0)
K = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]])


def scene(g: int, seed: int, wall: int = 8, behind: int = 0) -> dict:
    """`g` isotropic Gaussians in front of a camera at the origin looking
    down +z: the first `wall` of them wide and opaque at depth 3, where most
    tiles' pixels stop, the others scattered at depths 5 to 9 (the
    last `behind` of those mirrored behind the camera)."""
    gen = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=gen)
    z = 5.0 + 4.0 * u(g)
    z[:wall] = 3.0
    spread = torch.full((g, 1), 0.9)
    spread[:wall] = 0.5
    means = torch.cat([(u(g, 2) - 0.5) * spread * z[:, None], z[:, None]],
                      dim=-1)
    if behind:
        means[g - behind:, 2] *= -1.0
    s = 0.05 + 0.35 * u(g)
    s[:wall] = 2.0
    opacities = 0.3 + 0.69 * u(g)
    opacities[:wall] = 0.99
    return {"means": means,
            "covariances": torch.eye(3) * (s * s)[:, None, None],
            "harmonics": u(g, 3, 4) - 0.5, "opacities": opacities}


def bins_of(gaussians: dict):
    proj = project_gaussians(gaussians["means"], gaussians["covariances"],
                             gaussians["harmonics"], gaussians["opacities"],
                             torch.eye(4), K, (HW, HW))
    g = gaussians["means"].shape[0]
    bins = bin_gaussians_prefix(
        proj, (HW, HW), CFG.max_tiles_per_gaussian, CFG.chunk,
        entry_budget(CFG, g), base_tiles_per_gaussian=CFG.base_tiles_per_gaussian,
        big_pool_factor=CFG.big_pool_factor, depth_key="rank")
    return packed_rows(proj), bins


def brute_force(packed, bins) -> tuple[int, int, int]:
    """Each pixel walks its tile's entries one at a time, its transmittance
    multiplied entry by entry, and stops at the first with T (1 - alpha) <
    1e-4, which it does not blend; a tile walks as far as its furthest
    pixel."""
    tiles_y, tiles_x = bins.num_tiles_xy
    pix = torch.arange(TILE * TILE)
    px, py = (pix % TILE).float(), (pix // TILE).float()
    rows, entries, blended = set(), 0, 0
    for t in range(tiles_y * tiles_x):
        start, count = int(bins.starts[t]), int(bins.counts[t])
        seg = bins.src[start:start + count].long()
        if not count:
            continue
        r = packed[seg]                                  # (k, 10)
        ox, oy = float((t % tiles_x) * TILE), float((t // tiles_x) * TILE)
        dx = px[:, None] - (r[:, 0] - ox)[None, :]
        dy = py[:, None] - (r[:, 1] - oy)[None, :]
        power = (-0.5 * (r[:, 2] * dx * dx + r[:, 4] * dy * dy)
                 - r[:, 3] * dx * dy)
        alpha = torch.clamp(r[:, 8] * torch.exp(power), max=ALPHA_MAX)
        alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha,
                            torch.zeros_like(alpha)).numpy()
        extent = 0
        for p in range(TILE * TILE):
            walked, trans = count, np.float32(1.0)
            for j in range(count):
                trans = np.float32(trans * (np.float32(1.0) - alpha[p, j]))
                if trans < T_EPS:
                    walked = j + 1
                    break
                blended += bool(alpha[p, j] > 0)
            extent = max(extent, walked)
        entries += extent
        rows |= set(seg[:extent].tolist())
    return len(rows), entries, blended


@pytest.mark.parametrize("seed,chunk", [(1, 128), (2, 128), (3, 8)])
def test_walk_count_is_the_pixel_by_pixel_walk(seed, chunk):
    gaussians = scene(60, seed)
    packed, bins = bins_of(gaussians)
    assert int(bins.counts.max()) <= 128 or chunk < 128
    got = raster_work.walk_work(packed, bins.src, bins.counts, bins.starts,
                                bins.num_tiles_xy[1], chunk)
    assert got == brute_force(packed, bins)
    # The wall stops tiles before their ends: the walk reaches fewer
    # entries than the tiles list, and not every row.
    assert got[1] < int(bins.counts.sum())
    assert got[0] < 60


def test_gaussians_behind_the_camera_are_not_read():
    g = 60
    rows, entries, pairs = raster_work.camera_work(
        scene(g, 4, wall=0, behind=g // 2), torch.eye(4), K, torch.tensor(1.0),
        (HW, HW), CFG, scale_invariant=True)
    assert 0 < rows <= g // 2 < g
    assert entries > 0 and pairs > 0


def test_no_more_than_every_row_on_a_scene_without_duplicates():
    """Every Gaussian inside one tile (small, at a tile's centre): each row
    is listed once, so the count is at most the old one's g rows, plus a
    4-byte index an entry walked, which the old count left out; the
    blended pairs' operations take less time than those bytes."""
    g_tile = 6
    centres = torch.arange(TILE // 2, HW, TILE, dtype=torch.float32)
    cy, cx = torch.meshgrid(centres, centres, indexing="ij")
    uv = torch.stack([cx.flatten(), cy.flatten()], dim=-1)
    uv = uv.repeat_interleave(g_tile, dim=0)
    g = uv.shape[0]
    z = 2.0 + torch.arange(g, dtype=torch.float32) % g_tile
    xy = (uv - (0.5 * HW - 0.5)) / HW * z[:, None]
    gaussians = {"means": torch.cat([xy, z[:, None]], dim=-1),
                 "covariances": torch.eye(3).expand(g, 3, 3) * 1e-4,
                 "harmonics": torch.full((g, 3, 4), 0.2),
                 "opacities": torch.full((g,), 0.9)}
    packed, bins = bins_of(gaussians)
    assert int(bins.counts.sum()) == g                  # one entry a row
    rows, entries, pairs = raster_work.walk_work(
        packed, bins.src, bins.counts, bins.starts, bins.num_tiles_xy[1])
    assert (rows, entries, pairs) == brute_force(packed, bins)
    assert rows == entries <= g
    old_k1 = g * roofline.ROW_BYTES + roofline._out_bytes(HW)
    old_k2 = 2 * g * roofline.ROW_BYTES + 2 * roofline._out_bytes(HW)
    extra = g * roofline.ENTRY_BYTES
    assert roofline.k1_bytes(rows, entries, HW) <= old_k1 + extra
    assert roofline.k2_bytes(rows, entries, HW) <= old_k2 + extra
    assert pairs > 0
    for kernel, old in (("k1", old_k1), ("k2", old_k2)):
        least = roofline.raster_least_s(kernel, rows, entries, pairs, HW)
        assert least <= (old + extra) / roofline.PEAK_BYTES


def _readings(kind: str, launches_s: list, raster: list, items: int = 2):
    name = roofline.KERNELS["k1" if kind == "serve" else "k2"]
    device = [(int(i * 1e6), int(i * 1e6 + s * 1e9), name + "_float")
              for i, s in enumerate(launches_s)]
    segment = trace_mod.Trace(window_s=1.0, items=items, device=device)
    r = harness.Readings(kind, {}, {"image_size": HW}, 0.0, 1.0, items,
                         items, [], {}, None, None, {}, segment)
    r.raster = raster
    return r


@pytest.mark.parametrize("kind,metric,kernel", [
    ("serve", "k1_roofline.serve", "k1"),
    ("train", "k2_roofline.train", "k2")])
def test_raster_readers_take_every_traced_launch(kind, metric, kernel):
    """Two items of two cameras each: the share is the four launches'
    least time over their device time, a launch bound by its bytes or by
    its blended pairs' operations, whichever is larger; nothing where the
    launches are not the cameras counted, or without the count."""
    read = harness.load_metric(metric)
    bytes_of, pair_ops = roofline.RASTER[kernel]
    # Two launches bound by their bytes, two by their operations.
    raster = [(1000, 3000, 10), (500, 900, 0), (1000, 3000, 10**7),
              (10, 20, 10**6)]
    times = [4e-6, 4e-6, 2e-5, 3e-6]
    least = (sum(bytes_of(r, e, HW) for r, e, _ in raster[:2])
             / roofline.PEAK_BYTES
             + sum(p * pair_ops for _, _, p in raster[2:])
             / roofline.PEAK_FP32)
    for r, e, p in raster:
        assert math.isclose(roofline.raster_least_s(kernel, r, e, p, HW),
                            max(bytes_of(r, e, HW) / roofline.PEAK_BYTES,
                                p * pair_ops / roofline.PEAK_FP32))
    assert (raster[2][2] * pair_ops / roofline.PEAK_FP32
            > bytes_of(*raster[2][:2], HW) / roofline.PEAK_BYTES)
    got = read(_readings(kind, times, raster))
    assert math.isclose(got, 100.0 * least / sum(times))
    assert read(_readings(kind, times[:3], raster)) is None
    assert read(_readings(kind, times, None)) is None
    other = "train" if kind == "serve" else "serve"
    assert read(_readings(other, times, raster)) is None
