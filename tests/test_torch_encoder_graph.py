"""The encoders' inference forward as a CUDA graph replay: the flagship
("v2") and VGGT-1B ("v2l"); v1 stays eager by design.

On the CPU: the graph path stays off on the CPU, with autograd on and in
`train()` (the eager forward, bitwise, and no counter moves); `train()`
and moving the module drop the captured graphs; v1 never makes or enters
a graph cache and refuses view masks; the constants that the
forward used to copy from the host on each call equal the old ones in
value and dtype; the benchmark's readers of the replayed share.

On the card (`cuda`), the flagship at 256^2 and VGGT-1B at 224^2, with
2 + 1 views: a replay equals the eager forward bitwise; each signature
captures its own graph; outputs survive later calls; the counters; a
flagship replay's device trace holds as many K5 launches, and as many
launches of the view-masked kernel (the decoders' cross-attention), as
the eager forward's wrappers count.  This file imports torch and the port only
(no JAX):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_encoder_graph.py
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.models import adapter, build_encoder
from spfsplatv2_tpu_torch.models.croco.backbone import (
    CrocoBackboneConfig,
    MaskedCrocoBackbone,
)
from spfsplatv2_tpu_torch.models.croco.backbone_multi import (
    CrocoMultiBackboneConfig,
)
from spfsplatv2_tpu_torch.models.encoder import (
    SPFSplatV2Config,
    SPFSplatV2Encoder,
)
from spfsplatv2_tpu_torch.models.encoder_spfsplat import (
    SPFSplatConfig,
    SPFSplatEncoder,
)
from spfsplatv2_tpu_torch.models.encoder_vggt import (
    SPFSplatV2LConfig,
    SPFSplatV2LEncoder,
)
from spfsplatv2_tpu_torch.models.vggt import aggregator
from spfsplatv2_tpu_torch.ops import attention, cuda_lib
from spfsplatv2_tpu_torch.utils import cuda_graph

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    TINY_BACKBONE,
    TINY_HEADS,
    cuda_device,  # noqa: F401  (fixture)
    torch_tiny_vggt_config,
)

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("encoder_graph_replay", "encoder_graph_eager")
FIELDS = ("means", "covariances", "scales", "rotations", "harmonics",
          "opacities")


def tiny_encoder(kind="v2", seed=0):
    """The flagship ("v2"), v1 ("v1") or VGGT-1B ("v2l") at the tiny
    sizes, seeded."""
    if kind == "v2":
        enc = SPFSplatV2Encoder(SPFSplatV2Config(
            backbone=CrocoBackboneConfig(**TINY_BACKBONE), **TINY_HEADS))
    elif kind == "v1":
        enc = SPFSplatEncoder(SPFSplatConfig(
            backbone=CrocoMultiBackboneConfig(**TINY_BACKBONE),
            **TINY_HEADS))
    else:
        enc = SPFSplatV2LEncoder(torch_tiny_vggt_config())
    return enc.init_weights(torch.Generator().manual_seed(seed)).eval()


def views(seed, hw=32, v_cxt=2, v_tgt=1, device="cpu"):
    """(context images, intrinsics, target images, intrinsics)."""
    gen = torch.Generator().manual_seed(seed)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]])
    out = []
    for v in (v_cxt, v_tgt):
        out += [torch.rand((1, v, hw, hw, 3), generator=gen).to(device),
                k.expand(1, v, 3, 3).contiguous().to(device)]
    return out


def flat(out: dict) -> dict:
    """Every tensor of the encoder's output, the Gaussians' fields apart."""
    got = {k: v for k, v in out.items() if isinstance(v, torch.Tensor)}
    got.update({f"gaussians.{f}": getattr(out["gaussians"], f)
                for f in FIELDS})
    return got


def assert_bitwise(a: dict, b: dict):
    a, b = flat(a), flat(b)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


def eager_pieces(enc, args):
    """The forward as its parts, called one after another."""
    return enc._assemble(*enc._network(*args, None, None), global_step=0,
                         v_all=args[0].shape[1] + args[2].shape[1])


def refuse_the_graph_cache(monkeypatch):
    """Make entering the graph cache fail the test."""
    def refuse(*a, **k):
        raise AssertionError("the graph cache was entered")

    monkeypatch.setattr(cuda_graph.EncoderGraphs, "__call__", refuse)


# ------------------------------------------------------------------ CPU


GRAPH_OFF = ("cpu", "grad_on", "train_mode")


@pytest.mark.parametrize("kind,case", [
    *(pytest.param("v2", case, id=case) for case in GRAPH_OFF),
    *(pytest.param("v2l", case, id=f"v2l-{case}") for case in GRAPH_OFF),
])
def test_eager_path_where_the_graph_is_off(kind, case, monkeypatch):
    """On the CPU (and so with autograd on, or in `train()`) the forward
    never enters the graph cache, moves no counter and gives what its
    parts give, bit for bit."""
    enc = tiny_encoder(kind)
    args = views(1, hw=32 if kind == "v2" else 28)
    with torch.no_grad():
        want = eager_pieces(enc, args)

    refuse_the_graph_cache(monkeypatch)
    cuda_lib.reset_launch_counts()
    if case == "train_mode":
        enc.train()
    grad = torch.enable_grad() if case == "grad_on" else torch.no_grad()
    with grad:
        got = enc(*args)
    assert getattr(enc, "_graph_cache", None) is None
    assert all(cuda_lib.launch_counts[c] == 0 for c in COUNTERS)
    assert_bitwise(got, want)
    assert got["pts3d"].requires_grad == (case == "grad_on")


@pytest.mark.parametrize("encoder_cls", [
    "v2", "v1", pytest.param("v1-card", marks=pytest.mark.cuda), "v2l"])
def test_train_and_moves_drop_the_graphs(encoder_cls, request, monkeypatch):
    """`eval()` keeps the captured graphs; `train()` and a cast drop them
    (the flagship and VGGT-1B).  v1, eager by design, never makes or
    enters a graph cache: in `eval()` with autograd off, on the CPU and
    on the card, and after `train()` and a cast."""
    if encoder_cls.startswith("v1"):
        device = "cpu"
        if encoder_cls == "v1-card":
            device = request.getfixturevalue("cuda_device")
        enc = tiny_encoder("v1").to(device)
        refuse_the_graph_cache(monkeypatch)
        cuda_lib.reset_launch_counts()
        with torch.no_grad():
            out = enc(*views(1, device=device))
        enc.train()
        enc.double()
        assert out["variant"] == "spfsplat"
        assert not hasattr(enc, "_graphs")
        assert getattr(enc, "_graph_cache", None) is None
        assert all(cuda_lib.launch_counts[c] == 0 for c in COUNTERS)
        return
    enc = tiny_encoder(encoder_cls)
    cache = enc._graphs()
    assert enc._graphs() is cache and len(cache) == 0
    enc.eval()
    assert enc._graphs() is cache
    enc.train()
    assert enc._graph_cache is None
    enc.eval()
    cache = enc._graphs()
    enc.double()
    assert enc._graph_cache is None


@pytest.mark.parametrize("mask", ["context_valid", "target_valid"])
def test_v1_refuses_view_masks(mask):
    """v1 drops no views: the shared forward raises where it is given a
    view mask, rather than ignoring it."""
    enc = tiny_encoder("v1")
    args = views(1)
    n = args[0 if mask == "context_valid" else 2].shape[1]
    with pytest.raises(TypeError, match="drops no views"), torch.no_grad():
        enc(*args, **{mask: torch.ones((n,), dtype=torch.bool)})


def test_extra_token_positions_equal_the_host_built_ones():
    """The intrinsics and pose tokens' positions, now made on the device,
    equal the old host-built tensor in value and dtype, and the backbone
    matches it when the "manyar" embed's default true shapes are given
    as the old expression built them."""
    cfg = CrocoBackboneConfig(**TINY_BACKBONE)
    bb = MaskedCrocoBackbone(cfg)
    images = torch.rand((1, 2, 32, 48, 3), generator=torch.Generator()
                        .manual_seed(3)) * 2 - 1
    k = torch.eye(3).expand(1, 2, 3, 3)
    seen = {}

    def keep_pos(module, inputs):
        seen.setdefault("pos", inputs[1])

    bb.dec_blocks[0].register_forward_pre_hook(keep_pos)
    with torch.no_grad():
        bb(images, k)
    pos = seen["pos"]
    gh, p = 32 // 16, (32 // 16) * (48 // 16)
    old = torch.tensor([[gh + i, 0] for i in range(2)], dtype=pos.dtype)
    assert pos.dtype == old.dtype
    assert torch.equal(pos[:, :, p:], old[None, None].expand(1, 2, 2, 2))

    many = MaskedCrocoBackbone(CrocoBackboneConfig(**TINY_BACKBONE,
                                                   patch_embed_cls="manyar"))
    many.load_state_dict(bb.state_dict())
    with torch.no_grad():
        got = many(images, k)
        want = many(images, k, true_shapes=torch.tensor([32, 48]).expand(
            1, 2, 2))
    for a, b in zip(got["dec_feat"] + got["pose_feat"],
                    want["dec_feat"] + want["pose_feat"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_se3_bottom_row_and_sh_mask_equal_the_old_ones(dtype):
    """The SE3 bottom row and the SH mask, made once a device, equal the
    tensors each call used to copy from the host, in value and dtype; a
    packed pose is bitwise the old one."""
    old_row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype)
    row = se3._bottom_row(dtype, torch.device("cpu"))
    assert row.dtype == old_row.dtype and torch.equal(row, old_row)
    assert se3._bottom_row(dtype, torch.device("cpu")) is row
    gen = torch.Generator().manual_seed(4)
    r = torch.randn((2, 3, 3, 3), generator=gen, dtype=dtype)
    t = torch.randn((2, 3, 3), generator=gen, dtype=dtype)
    old = torch.cat([torch.cat([r, t[..., None]], dim=-1),
                     old_row.expand(2, 3, 1, 4)], dim=-2)
    assert torch.equal(se3.pack_rt(r, t), old)
    for degree in (0, 1, 4):
        old_mask = torch.as_tensor(adapter.sh_mask(degree))
        mask = adapter._sh_mask_on(degree, torch.device("cpu"))
        assert mask.dtype == old_mask.dtype and torch.equal(mask, old_mask)


def test_aggregator_norm_constants_equal_the_old_ones():
    """The aggregator's ImageNet mean and std, made once a device, equal
    the tensors each call used to copy from the host, in value and dtype,
    and the images reach DINOv2 normalised bitwise as before."""
    old = (torch.tensor(aggregator.RESNET_MEAN),
           torch.tensor(aggregator.RESNET_STD))
    got = aggregator._resnet_mean_std(torch.device("cpu"),
                                      torch.get_default_dtype())
    assert aggregator._resnet_mean_std(torch.device("cpu"),
                                       torch.get_default_dtype()) is got
    for a, b in zip(got, old):
        assert a.dtype == b.dtype and torch.equal(a, b)
    enc = tiny_encoder("v2l")
    images = torch.rand((1, 3, 28, 28, 3),
                        generator=torch.Generator().manual_seed(2))
    seen = {}
    enc.aggregator.patch_embed.register_forward_pre_hook(
        lambda module, inputs: seen.setdefault("images", inputs[0]))
    with torch.no_grad():
        enc.aggregator(images, torch.eye(3).expand(1, 3, 3, 3))
    want = ((images - old[0]) / old[1]).reshape(3, 28, 28, 3)
    assert torch.equal(seen["images"], want)


def _encoder_graph_share(name="serve.encoder_graph_share"):
    from portbench import harness

    return harness.load_metric(name)


SHARE_CASES = [
    ("serve", {"encoder_graph_replay": 1.0, "encoder_graph_eager": 0.0}, 100.0),
    ("serve", {"encoder_graph_replay": 3.0, "encoder_graph_eager": 1.0}, 75.0),
    ("serve", {"encoder_graph_replay": 0.0, "encoder_graph_eager": 0.0}, None),
    ("serve", {"flash_forward": 48.0}, None),
    ("train", {"encoder_graph_replay": 0.0, "encoder_graph_eager": 0.0}, None),
]


@pytest.mark.parametrize("kind,launches,want", SHARE_CASES)
def test_encoder_graph_share_reader(kind, launches, want):
    """The benchmark's reader: replays over graph-eligible forwards in %,
    nothing where neither counter moved or is known."""
    read = _encoder_graph_share()
    assert read(SimpleNamespace(kind=kind, launches=launches)) == want


@pytest.mark.parametrize("kind,launches,want", SHARE_CASES)
def test_vggt_encoder_graph_share_reader(kind, launches, want):
    """VGGT-1B's serving cell reads the same share by the same rule."""
    read = _encoder_graph_share("serve.encoder_graph_share.v2l")
    assert read(SimpleNamespace(kind=kind, launches=launches)) == want


# ----------------------------------------------------------------- card

HW = 256  # the flagship's served size
SERVED = {"v2": HW, "v2l": 224}


def on_card(build, cfg):
    """`build(cfg)` on the card, seeded, with TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return build(cfg, seed=0, device="cuda")


@pytest.fixture(scope="module")
def flagship():
    """The flagship encoder (bf16 backbone, float32 heads), seeded."""
    return on_card(build_encoder, SPFSplatV2Config())


@pytest.fixture(scope="module")
def vggt():
    """VGGT-1B at full width (bf16 aggregator, float32 heads), seeded."""
    return on_card(build_encoder, SPFSplatV2LConfig())


@pytest.fixture(params=list(SERVED))
def served(request):
    """(encoder, served size) of each graphed encoder."""
    name = "flagship" if request.param == "v2" else "vggt"
    return request.getfixturevalue(name), SERVED[request.param]


def fresh(enc):
    """`enc` in `eval()` with no graphs and the counters at 0."""
    enc.train()
    enc.eval()
    cuda_lib.reset_launch_counts()
    return enc


def counters():
    return {c: cuda_lib.launch_counts[c] for c in COUNTERS}


@pytest.mark.cuda
def test_replay_equals_the_eager_forward_bitwise(cuda_device, served):
    """The first call (eager, before the capture) and the replays equal
    the eager forward in `train()` bit for bit: poses, Gaussians, pts3d
    (and VGGT-1B's confidence), depths and densities; a view-dropout call
    likewise: 3 context views, the middle one dropped, as training's
    dropout keeps the first and the last (with one valid context view
    left, the flagship's view 0 has no view to attend to in its
    cross-attention, and the eager forward is NaN too)."""
    enc, hw = served
    enc = fresh(enc)
    args = views(5, hw, device=cuda_device)
    drop = views(5, hw, v_cxt=3, device=cuda_device)
    valid = torch.tensor([True, False, True], device=cuda_device)
    with torch.no_grad():
        enc.train()
        want = enc(*args)
        want_valid = enc(*drop, context_valid=valid)
        enc.eval()
        first = enc(*args)
        replays = [enc(*args) for _ in range(2)]
        valid_runs = [enc(*drop, context_valid=valid) for _ in range(2)]
    torch.cuda.synchronize()
    for got in (first, *replays):
        assert_bitwise(got, want)
    for got in valid_runs:
        assert_bitwise(got, want_valid)
    assert not want_valid["gaussians"].opacities[:, hw * hw:2 * hw * hw].any()
    assert counters() == {"encoder_graph_replay": 3, "encoder_graph_eager": 2}


@pytest.mark.cuda
def test_each_signature_captures_its_graph(cuda_device, served):
    """A new signature (no target view; another size) captures a graph of
    its own and replays it; the first one still replays."""
    enc, hw = served
    enc = fresh(enc)
    full = views(6, hw, device=cuda_device)
    with torch.no_grad():
        for _ in range(2):
            enc(*full)
        assert len(enc._graph_cache) == 1
        for _ in range(2):
            ctx_only = enc(*full[:2])
        assert len(enc._graph_cache) == 2
        for _ in range(2):
            enc(*views(6, hw // 2, device=cuda_device))
        assert len(enc._graph_cache) == 3
        enc(*full)
        enc.train()
        want = enc(*full[:2])
        enc.eval()
    assert counters() == {"encoder_graph_replay": 4, "encoder_graph_eager": 3}
    assert ctx_only["extrinsics_cwt"].shape == (1, 2, 4, 4)
    assert_bitwise(ctx_only, want)


@pytest.mark.cuda
def test_outputs_do_not_alias_the_graph(cuda_device, served):
    """What a replay returns stays as it was after later replays on other
    views (nothing returned lies in the graph's memory)."""
    enc, hw = served
    enc = fresh(enc)
    with torch.no_grad():
        enc(*views(7, hw, device=cuda_device))
        out1 = enc(*views(8, hw, device=cuda_device))
        kept = {k: v.clone() for k, v in flat(out1).items()}
        out2 = enc(*views(9, hw, device=cuda_device))
    torch.cuda.synchronize()
    for name, v in flat(out1).items():
        assert torch.equal(v, kept[name]), name
    assert not torch.equal(flat(out2)["pts3d"], kept["pts3d"])
    ptrs = {t.untyped_storage().data_ptr() for t in flat(out1).values()}
    assert not ptrs & {t.untyped_storage().data_ptr()
                       for t in flat(out2).values()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grad_on", "train_mode"])
def test_graph_stays_off_with_autograd_or_in_training(cuda_device, served,
                                                      case):
    """On the card, autograd on or `train()` runs the eager forward: no
    graph, no counter moves."""
    enc, hw = served
    enc = fresh(enc)
    args = views(10, hw, device=cuda_device)
    if case == "train_mode":
        enc.train()
    with (torch.enable_grad() if case == "grad_on" else torch.no_grad()):
        enc(*args)
    enc.eval()
    assert getattr(enc, "_graph_cache", None) is None
    assert counters() == {c: 0 for c in COUNTERS}


@pytest.mark.cuda
def test_k5_launches_count_the_same_replayed(cuda_device, flagship,
                                             monkeypatch):
    """With FLASH_MIN_KV lowered so that every self-attention takes K5
    (24 encoder and 24 decoder blocks), the eager forward's wrappers count
    48 K5 forward launches, and a replay's device trace holds 48 of K5's
    forward kernel while its wrappers count none.  The first graph-path
    call counts 96: its eager run and its capture.  The replays equal the
    eager forward bitwise."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(attention, "FLASH_MIN_KV", 16)
    enc = fresh(flagship)
    args = views(11, HW, device=cuda_device)
    per_call, outs = [], []
    with torch.no_grad():
        enc.train()
        want = enc(*args)
        per_call.append(cuda_lib.launch_counts["flash_forward"])
        enc.eval()
        for _ in range(2):
            before = cuda_lib.launch_counts["flash_forward"]
            outs.append(enc(*args))
            per_call.append(cuda_lib.launch_counts["flash_forward"] - before)
        torch.cuda.synchronize()
        before = cuda_lib.launch_counts["flash_forward"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            outs.append(enc(*args))
            torch.cuda.synchronize()
        per_call.append(cuda_lib.launch_counts["flash_forward"] - before)
    traced = sum(e.device_type == torch.autograd.DeviceType.CUDA
                 and "flash_forward_kernel" in e.name for e in prof.events())
    assert per_call == [48, 96, 0, 0]
    assert traced == 48
    assert counters() == {"encoder_graph_replay": 2, "encoder_graph_eager": 1}
    for got in outs:
        assert_bitwise(got, want)


@pytest.mark.cuda
def test_view_masked_launches_count_the_same_replayed(cuda_device, flagship,
                                                      monkeypatch):
    """With FLASH_MIN_KV lowered to 512, the decoders' cross-attention
    (774 keys at 256^2, 2 + 1 views) takes the view-masked kernel while
    the self-attentions (256 and 258 keys) stay dense: the eager forward's
    wrappers count 24 launches (12 layers x 2 decoders) and no dense
    logits, the first graph-path call 48 (its eager run and its capture),
    a replay none, while its device trace holds 24 of the kernel.  The
    replays equal the eager forward bitwise."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(attention, "FLASH_MIN_KV", 512)
    enc = fresh(flagship)
    args = views(12, HW, device=cuda_device)
    per_call, outs = [], []

    def launched():
        return cuda_lib.launch_counts["flash_view_masked"]

    with torch.no_grad():
        enc.train()
        want = enc(*args)
        per_call.append(launched())
        enc.eval()
        for _ in range(2):
            before = launched()
            outs.append(enc(*args))
            per_call.append(launched() - before)
        torch.cuda.synchronize()
        before = launched()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            outs.append(enc(*args))
            torch.cuda.synchronize()
        per_call.append(launched() - before)
    traced = sum(e.device_type == torch.autograd.DeviceType.CUDA
                 and "view_masked_fwd_kernel" in e.name for e in prof.events())
    assert per_call == [24, 48, 0, 0]
    assert traced == 24
    assert cuda_lib.launch_counts["masked_attn_logits"] == 0
    assert cuda_lib.launch_counts["flash_forward"] == 0
    for got in outs:
        assert_bitwise(got, want)
