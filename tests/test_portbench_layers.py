"""`portbench/layers.py`: a traced segment charged to the program's spans.

Hand-made Chrome-trace events hold one rule each: a launch charged by
its `correlation` to the innermost span on its thread; a backward node
charged by its `Sequence number` to the span of the forward operation
that made it, remat's recompute to the span it enters again; an idle gap
charged to the layer of the host operation `trace.read` labels it with;
the layers and `other` summing to the untraced item time.  Last, a tiny
training cell's real CPU trace, with a launch and a kernel added under
each aten operation, splits by every training span.
"""

from __future__ import annotations

import pytest
import torch

from portbench import harness, layers
from portbench.tests.tiny import tiny_cell

MAIN, AUTOGRAD = 1, 2


def ev(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def span(name, ts, dur, tid=MAIN):
    return ev("user_annotation", "spfsplat:" + name, ts, dur, tid)


def launch(corr, at, start, dur=1.0, tid=MAIN):
    """A runtime launch at `at` on `tid` and its kernel on the card."""
    return [ev("cuda_runtime", "cudaLaunchKernel", at, 0.5, tid,
               correlation=corr),
            ev("kernel", f"kernel_{corr}", start, dur, "stream 7",
               correlation=corr)]


def segment(dur):
    return ev("user_annotation", "portbench:segment", 0, dur)


def node(seq, ts, dur, tid=AUTOGRAD):
    return ev("cpu_op", "autograd::engine::evaluate_function: XBackward0",
              ts, dur, tid, **{"Sequence number": seq, "Fwd thread id": 1})


def op(name, ts, dur, tid=MAIN, seq=None):
    args = {} if seq is None else {"Sequence number": seq,
                                   "Fwd thread id": 0}
    return ev("cpu_op", name, ts, dur, tid, **args)


def busy(split):
    """(busy ms, launches) of each layer that launched."""
    got = {key: c for key, c in split.layers.items() if c.launches}
    return ({key: c.busy_ms for key, c in got.items()},
            {key: c.launches for key, c in got.items()})


def test_launch_charged_by_correlation_to_innermost_span():
    events = [segment(100),
              span("encoder.backbone", 10, 30),
              span("decoder.render", 45, 25), span("render.bin", 50, 10),
              *launch(1, 12, 20, 10),       # encoder.backbone
              *launch(2, 52, 55, 10),       # render.bin, inside the render
              *launch(4, 47, 64, 4),        # the render, outside render.bin
              *launch(3, 80, 82, 2)]        # no span: the harness
    ms, n = busy(layers.split(events, 1, 1e-4))
    # Kernel 4 overlaps kernel 2 for 1 us: the union counts it once.
    assert ms == pytest.approx({("encoder.backbone", "fwd"): 0.010,
                                ("render.bin", "fwd"): 0.010,
                                ("decoder.render", "fwd"): 0.003,
                                ("other", "fwd"): 0.002})
    assert set(n.values()) == {1}


def test_backward_node_charged_by_sequence_number():
    events = [segment(100),
              span("encoder.backbone", 0, 1.8),
              op("aten::mul", 0.5, 1, seq=7),   # same number, made no node
              span("encoder.heads", 2, 8),
              op("aten::addmm", 3, 2, seq=7),   # made node 7
              span("loss.mse", 10, 10),
              op("aten::sub", 12, 1, seq=8),
              op("aten::mul", 14, 1),           # no gradient: no number
              node(7, 30, 10), *launch(5, 32, 33, 3, AUTOGRAD),
              node(8, 41, 4), *launch(6, 42, 44, 1, AUTOGRAD),
              node(99, 46, 3), *launch(7, 47, 47.5, 1, AUTOGRAD),
              # Remat: the recompute enters the heads' span again inside a
              # node, and its own ops (number 8 again) make no node.
              node(7, 50, 10), span("encoder.heads", 51, 8, AUTOGRAD),
              op("aten::sub", 53, 1, AUTOGRAD, seq=8),
              *launch(8, 52, 52.5, 1, AUTOGRAD)]
    ms, n = busy(layers.split(events, 1, 1e-4))
    assert ms == pytest.approx({("encoder.heads", "bwd"): 0.004,
                                ("loss.mse", "bwd"): 0.001,
                                ("other", "bwd"): 0.001})
    assert n == {("encoder.heads", "bwd"): 2, ("loss.mse", "bwd"): 1,
                 ("other", "bwd"): 1}


def test_gaps_charged_like_trace_read_and_scaled_to_the_item():
    events = [segment(100),
              *launch(1, 1, 10, 10), *launch(2, 2, 50, 10),
              span("encoder.backbone", 0, 9),        # the gap 0-10, no op
              span("loss.lpips", 25, 20),
              op("aten::mul", 30, 10),               # the gap 20-50
              ev("cuda_runtime", "cudaStreamSynchronize", 61, 30,
                 correlation=9)]                     # the gap 60-100: other
    split = layers.split(events, 1, 1e-4)            # 0.1 ms, as traced
    idle = {key: c.idle_ms for key, c in split.layers.items()}
    assert split.k == pytest.approx(1.0)
    assert idle == pytest.approx({("encoder.backbone", "fwd"): 0.010,
                                  ("loss.lpips", "fwd"): 0.030,
                                  ("other", "fwd"): 0.040})
    assert split.layers[("other", "fwd")].syncs == 1
    # The same segment as two items whose untraced window took 0.09 ms
    # an item: 0.01 ms busy and 0.04 ms idle an item as traced, so the
    # idle time is doubled to fill the item.
    split = layers.split(events, 2, 9e-5)
    assert split.k == pytest.approx(2.0)
    assert sum(c.ms for c in split.layers.values()) == pytest.approx(0.09)
    assert split.layers[("loss.lpips", "fwd")].idle_ms == pytest.approx(0.03)


def test_metrics_read_layers_by_prefix_and_direction():
    split = layers.Split(item_ms=10.0, k=1.0, layers={
        ("encoder.backbone", "fwd"): layers.Cost(1.0, 0.5),
        ("encoder.heads", "bwd"): layers.Cost(2.0, 0.0),
        ("decoder.render", "fwd"): layers.Cost(0.25, 0.25),
        ("render.composite", "bwd"): layers.Cost(1.0, 0.0),
        ("other", "fwd"): layers.Cost(0.0, 5.0)})
    assert split.metric("train.encoder_fwd_ms") == 1.5
    assert split.metric("train.encoder_bwd_ms") == 2.0
    assert split.metric("train.render_ms") == 1.5
    assert split.metric("serve.backbone_ms") == 1.5
    assert split.metric("train.loss_ms") is None     # no such span ran
    assert [r["layer"] for r in split.table()][:2] == ["other",
                                                       "encoder.heads"]


def with_launches(events):
    """A CPU trace with a launch in the middle of each aten operation and
    its 1 us kernel on a card that runs them in order."""
    out, card, corr = list(events), 0.0, 0
    for e in sorted(events, key=lambda e: float(e["ts"])):
        if e.get("cat") == "cpu_op" and e["name"].startswith("aten::"):
            corr += 1
            at = float(e["ts"]) + float(e["dur"]) / 2
            card = max(card, at + 1)
            out += launch(corr, at, card, 1.0, e["tid"])
            card += 1
    return out


def test_tiny_training_cell_splits_by_every_span():
    torch.set_num_threads(2)
    cell = tiny_cell("v2-train-256-b16")
    with layers.kept_events() as kept:
        out = harness.run_cell(cell, 5, 0.0, True, torch.device("cpu"), 0.0,
                               log=lambda s: None)
    r = out.readings
    split = layers.split(with_launches(kept[-1]), r.trace.items,
                         r.window_s / r.items)
    names = {key for key, c in split.layers.items() if c.launches}
    assert {("encoder.backbone", "fwd"), ("encoder.backbone", "bwd"),
            ("encoder.heads", "fwd"), ("encoder.heads", "bwd"),
            ("encoder.gaussians", "fwd"), ("render.project", "fwd"),
            ("loss.mse", "fwd"), ("loss.lpips", "fwd"),
            ("loss.lpips", "bwd"), ("loss.reproj", "fwd"),
            ("train.optimizer", "fwd")} <= names
    assert sum(c.ms for c in split.layers.values()) == pytest.approx(
        split.item_ms)
    for name, (kind, _, _) in layers.METRICS.items():
        if kind == "train":
            assert split.metric(name) > 0, name
