"""The port's program spans (`utils/profiling.py:span`), on the CPU and,
marked `cuda`, on the card.  Imports no JAX.

  * with no profiler recording, `span` never enters `record_function`;
  * a tiny flagship train step under the profiler shows every span of the
    train step, each nested in its parent, and a serve request of each
    encoder (flagship, VGGT, v1) the encoder's and the render's spans;
  * on the card, a kernel launched inside a span starts after the span
    on the profiler's timeline: the spans share the device trace's clock.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spfsplatv2_tpu_torch.evaluation.profile_request import (
    synthetic_batch,
    synthetic_request,
)
from spfsplatv2_tpu_torch.losses.lpips import build_lpips
from spfsplatv2_tpu_torch.models.croco.backbone import CrocoBackboneConfig
from spfsplatv2_tpu_torch.models.croco.backbone_multi import (
    CrocoMultiBackboneConfig,
)
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig, decode_splatting
from spfsplatv2_tpu_torch.models.encoder import (
    SPFSplatV2Config,
    SPFSplatV2Encoder,
)
from spfsplatv2_tpu_torch.models.encoder_spfsplat import (
    SPFSplatConfig,
    SPFSplatEncoder,
)
from spfsplatv2_tpu_torch.models.encoder_vggt import SPFSplatV2LEncoder
from spfsplatv2_tpu_torch.ops.segscan import cumsum_1d
from spfsplatv2_tpu_torch.training.optim import Optimizer, OptimizerConfig
from spfsplatv2_tpu_torch.training.step import (
    LossConfig,
    init_train_state,
    make_train_step,
)
from spfsplatv2_tpu_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    TINY_BACKBONE,
    TINY_HEADS,
    cuda_device,  # noqa: F401  (fixture)
    torch_tiny_vggt_config,
)

CPU = torch.device("cpu")
ENCODER = ("encoder.backbone", "encoder.heads", "encoder.gaussians")
RENDER = ("render.project", "render.bin", "render.composite")
# Span -> the span that holds it (None: no program span does).
SERVE_PARENTS = {**{s: None for s in ENCODER}, "decoder.render": None,
                 **{s: "decoder.render" for s in RENDER}}
# v1's two decoder passes (`backbone_multi.py`), inside its backbone.
V1_DECODE = {"encoder.decode_context": "encoder.backbone",
             "encoder.decode_all": "encoder.backbone"}
TRAIN_PARENTS = {**{s: "train.forward" for s in ENCODER},
                 "decoder.render": "train.forward",
                 **{s: "decoder.render" for s in RENDER},
                 "loss.mse": "train.forward", "loss.lpips": "train.forward",
                 "loss.reproj": "train.forward", "train.forward": None,
                 "train.backward": None, "train.optimizer": None}


def tiny_encoder(name: str):
    gen = torch.Generator().manual_seed(3)
    if name == "spfsplatv2":
        enc = SPFSplatV2Encoder(SPFSplatV2Config(
            backbone=CrocoBackboneConfig(**TINY_BACKBONE), **TINY_HEADS))
    elif name == "spfsplat":
        enc = SPFSplatEncoder(SPFSplatConfig(
            backbone=CrocoMultiBackboneConfig(**TINY_BACKBONE), **TINY_HEADS))
    else:
        enc = SPFSplatV2LEncoder(torch_tiny_vggt_config())
    return enc.init_weights(gen)


def program_spans(prof) -> list[tuple[str, float, float, int]]:
    """(name, start us, end us, thread) of the profile's program spans
    on the host (not their copies on the card's rows)."""
    return [(e.name[len(profiling.SPAN_PREFIX):], e.time_range.start,
             e.time_range.end, e.thread) for e in prof.events()
            if e.name.startswith(profiling.SPAN_PREFIX)
            and e.device_type == torch.autograd.DeviceType.CPU]


def parent(spans, child) -> str | None:
    """The innermost other span, on the same thread, that holds `child`."""
    name, s, e, tid = child
    holders = [p for p in spans if p is not child and p[3] == tid
               and p[1] <= s and e <= p[2]]
    return max(holders, key=lambda p: p[1])[0] if holders else None


def check_nesting(spans, parents: dict) -> None:
    assert {s[0] for s in spans} == set(parents)
    for child in spans:
        assert parent(spans, child) == parents[child[0]], child


def test_span_off_never_enters_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("encoder.backbone"):
        x = torch.ones(2) + 1
    assert profiling.span("a") is profiling.span("b")
    assert x.sum() == 4


def test_span_under_profiler_is_a_named_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("encoder.heads"):
            with profiling.span("render.bin"):
                torch.ones(4).cumsum(0)
    spans = program_spans(prof)
    assert [s[0] for s in spans] == ["encoder.heads", "render.bin"]
    assert parent(spans, spans[1]) == "encoder.heads"


def test_train_step_spans_nest_as_the_layers():
    torch.manual_seed(0)
    hw = TINY_BACKBONE["patch_size"] * 2
    enc = tiny_encoder("spfsplatv2")
    optimizer = Optimizer(OptimizerConfig(), enc.named_parameters())
    step = make_train_step(enc, optimizer, (hw, hw), DecoderConfig(),
                           LossConfig(), lpips=build_lpips(0, CPU))
    state = init_train_state(enc, optimizer)
    batch = synthetic_batch(1, 2, hw, CPU)
    step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    spans = program_spans(prof)
    check_nesting(spans, TRAIN_PARENTS)
    # One render a scene, the three render spans a camera.
    assert sum(s[0] == "render.composite" for s in spans) == 2


@pytest.mark.parametrize("name", ["spfsplatv2", "spfsplatv2l", "spfsplat"])
@torch.no_grad()
def test_serve_request_spans_nest_as_the_layers(name):
    torch.manual_seed(0)
    hw = 28 if name == "spfsplatv2l" else TINY_BACKBONE["patch_size"] * 2
    enc = tiny_encoder(name).eval()
    req = synthetic_request(2, hw, CPU)
    ctx = {k: req["context"][k][None] for k in ("image", "intrinsics")}
    tgt = {k: req["target"][k][None] for k in ("image", "intrinsics", "near",
                                               "far")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = enc(ctx["image"], ctx["intrinsics"], tgt["image"],
                  tgt["intrinsics"])
        decode_splatting(out["gaussians"], out["extrinsics_cwt"][:, 2:],
                         tgt["intrinsics"], tgt["near"], tgt["far"], (hw, hw))
    parents = SERVE_PARENTS
    if name == "spfsplat":
        parents = {**SERVE_PARENTS, **V1_DECODE}
    check_nesting(program_spans(prof), parents)


@pytest.mark.cuda
def test_span_shares_the_device_clock(cuda_device):
    """K3 and a cuBLAS product launched inside a span start on the card
    after the span starts, on the one timeline of the profiler."""
    vals = torch.arange(1 << 16, dtype=torch.float32, device=cuda_device)
    a = torch.ones(512, 512, device=cuda_device)
    cumsum_1d(vals)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.span("render.bin"):
            cumsum_1d(vals)
            a @ a
        torch.cuda.synchronize()
    (_, start, _, _), = program_spans(prof)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(profiling.SPAN_PREFIX)]
    assert any("scan" in e.name for e in kernels), [e.name for e in kernels]
    assert len(kernels) >= 2
    for e in kernels:
        assert e.time_range.start >= start, (e.name, e.time_range, start)
