"""`vm_fwd_roofline.serve`: the view-masked kernel's calls a request and
the query-key pairs each leaves visible, against the token-level mask's
own count, at both models' 1024^2 shapes; its reader."""

from __future__ import annotations

import math

import pytest

from portbench import harness, roofline, view_masked
from portbench import trace as trace_mod
from portbench.reference.models.croco.backbone import build_cross_view_mask

METRIC = "vm_fwd_roofline.serve"


def mask_pairs(views: int, num_target: int, tokens: int, lo: int,
               hi: int) -> int:
    """The true entries of the (query tokens, key tokens) mask of query
    views [lo, hi) over every view, expanded from the model's view mask."""
    seen = build_cross_view_mask(views, num_target)[lo:hi] == 0
    dense = seen.repeat_interleave(tokens, 0).repeat_interleave(tokens, 1)
    return int(dense.sum())


@pytest.mark.parametrize("workload,passes,tokens", [
    # The flagship: one pass over 2 + 1 views, the target masked from the
    # context views' queries; 4,096 patches + intrinsics and pose tokens.
    ("v2-serve-1024", [(3, 1)], 4098),
    # v1: the context pass, then the all-views pass, neither masked.
    ("v1-serve-1024", [(2, 0), (3, 0)], 4097)])
def test_visible_pairs_are_the_masks_count(workload, passes, tokens):
    cell = harness.load_cell(workload)
    shapes = view_masked.request_shapes(cell.config, cell.traffic)
    depth = cell.config["encoder"]["backbone"]["dec_depth"]
    want = []
    for views, num_target in passes:
        want += [(1, 12, mask_pairs(views, num_target, tokens, 0, 1), 64),
                 (1, 12, mask_pairs(views, num_target, tokens, 1, views),
                  64)] * depth
    assert shapes == want
    assert len(shapes) == (view_masked.flagship_calls if workload[1] == "2"
                           else view_masked.v1_calls)(cell.config,
                                                      cell.traffic)


def test_least_times_are_the_kernel_tables():
    """The bounds of the kernel table (PERF.md): 0.0522 / 0.1565 ms at the
    flagship's two calls, 0.0521 / 0.1043 / 0.2086 ms at v1's three."""
    ms = lambda w: [round(view_masked.flops([s]) / roofline.PEAK_BF16 * 1e3,
                          4) for s in view_masked.request_shapes(
        harness.load_cell(w).config, harness.load_cell(w).traffic)[:2]]
    assert ms("v2-serve-1024") == [0.0522, 0.1565]
    v1 = harness.load_cell("v1-serve-1024")
    shapes = view_masked.request_shapes(v1.config, v1.traffic)
    got = sorted({round(view_masked.flops([s]) / roofline.PEAK_BF16 * 1e3, 4)
                  for s in shapes})
    assert got == [0.0521, 0.1043, 0.2086]


def _readings(workload: str, launches: int, items: int = 2, seconds=1e-3):
    cell = harness.load_cell(workload)
    name = "_anonymous_namespace_::" + view_masked.KERNEL + "_CUtensorMap"
    device = [(0, int(seconds / max(launches, 1) * 1e9), name)] * launches
    segment = trace_mod.Trace(window_s=1.0, items=items, device=device)
    return harness.Readings("serve", cell.config, cell.traffic, 0.0, 1.0,
                            items, items, [], {}, None, None, {}, segment)


@pytest.mark.parametrize("workload", ["v2-serve-1024", "v1-serve-1024"])
def test_reader_over_both_cells(workload):
    read = harness.load_metric(METRIC)
    cell = harness.load_cell(workload)
    assert METRIC in {m["name"] for m in cell.per_layer}
    shapes = view_masked.request_shapes(cell.config, cell.traffic)
    n = 2 * len(shapes)
    least = 2 * view_masked.flops(shapes) / roofline.PEAK_BF16
    got = read(_readings(workload, n, seconds=0.05))
    assert math.isclose(got, 100.0 * least / 0.05, rel_tol=1e-6)
    assert read(_readings(workload, n - 1)) is None
    assert read(_readings(workload, 0)) is None


@pytest.mark.parametrize("workload", ["v2-serve-256", "v2l-serve-224"])
def test_reader_silent_without_the_kernels_calls(workload):
    read = harness.load_metric(METRIC)
    assert read(_readings(workload, 4)) is None
    assert METRIC not in {m["name"]
                          for m in harness.load_cell(workload).per_layer}


def test_logits_reader_counts_the_kernels_visible_pairs():
    """`serve.masked_logits_gib` in `v1-serve-1024`: the kernel's 48
    launches a request form the visible pairs' logits (72.04 GiB at 4
    bytes, under the dense branch's 117.06); the dense branch's count
    adds to them; launches that do not match the calls read nothing."""
    read = harness.load_metric("serve.masked_logits_gib")
    cell = harness.load_cell("v1-serve-1024")
    shapes = view_masked.request_shapes(cell.config, cell.traffic)
    visible = sum(b * h * pairs for b, h, pairs, _ in shapes)

    def readings(launches):
        return harness.Readings("serve", cell.config, cell.traffic, 0.0,
                                1.0, 2, 2, [], {}, None, None, launches)

    got = read(readings({"flash_view_masked": len(shapes)}))
    assert got == visible * 4 / 2**30 and round(got, 2) == 72.04
    assert read(readings({"flash_view_masked": len(shapes),
                          "masked_attn_logits": 10})) == \
        (visible + 10) * 4 / 2**30
    assert read(readings({"masked_attn_logits": 10})) == 10 * 4 / 2**30
    assert read(readings({"flash_view_masked": len(shapes) - 1})) is None
    assert read(readings({})) is None
