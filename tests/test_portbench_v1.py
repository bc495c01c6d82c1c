"""SPFSplat v1 in the benchmark (`portbench/`), on the CPU at a tiny size.

The port's v1 encoder against the plain reference
(`portbench/reference/models/encoder_spfsplat.py`) from the same seeded
weight plan; the new serving cells run whole through the harness; the
`masked_attn_logits` counter of `ops/attention.py:sdpa_view_masked`; the
K5 shapes that `portbench/roofline_v1.py` counts against the attention
calls of a v1 forward; the reference's imports; and the readers of the
view-masked kernel's share in both 1024^2 serving cells.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, roofline, roofline_v1
from portbench import traffic as traffic_gen
from portbench.tests.tiny import TINY_ENCODER, TINY_TRAFFIC, merge
from spfsplatv2_tpu_torch.config import load_config
from spfsplatv2_tpu_torch.ops import attention, cuda_lib

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2**31 + 77
V1 = "v1-serve-1024"
# Both sides in float32 on the CPU run the same operations: the port's
# kernels take their plain versions, which are the reference's frozen
# copies, so the outputs agree to float32 rounding (sums in another
# order, 1e-7 relative a product); 1e-5 leaves room for a few dozen
# such products through the depth of the tiny encoder and its heads.
FORWARD_TOL = 1e-5
# The harness's own numbers (the render's tile means, the sampled
# Gaussians, the poses), the same bar as the other cells' tiny runs.
HARNESS_TOL = 1e-4


def tiny_cell(workload: str) -> harness.Cell:
    """The cell with the tiny encoder, in float32, at 2 x 2 patches."""
    cell = harness.load_cell(workload)
    v1 = cell.config_name == "spfsplat-re10k"
    # v1 at the flagship's tiny widths (the same backbone keys).
    tiny = TINY_ENCODER["spfsplatv2-re10k" if v1 else cell.config_name]
    cell.config = merge(cell.config, {"encoder": tiny})
    cell.config["encoder"] = harness.all_float32(cell.config["encoder"])
    patch = 16 if v1 else 14
    cell.traffic = merge(cell.traffic, {**TINY_TRAFFIC["serve"],
                                        "image_size": 2 * patch})
    cell.traffic["decoder"]["rasterizer"]["depth_key"] = "rank"
    cell.limits = {"limits": {}}
    return cell


def masked_logits(config: dict, traffic: dict) -> int:
    """A v1 request's dense masked logits: a layer of each decoder pass
    writes every query view's tokens against every view's, over its
    heads, (v l)^2 h."""
    bb = config["encoder"]["backbone"]
    v_cxt = len(traffic["context_offsets"])
    v_all = v_cxt + len(traffic["target_offsets"])
    l = (traffic["image_size"] // bb["patch_size"]) ** 2 + 1
    return (bb["dec_depth"] * bb["dec_num_heads"] * l ** 2
            * (v_cxt ** 2 + v_all ** 2))


def forward(enc, req: dict) -> dict:
    ctx, tgt = req["context"], req["target"]
    with torch.no_grad():
        return enc(ctx["image"][None], ctx["intrinsics"][None],
                   tgt["image"][None], tgt["intrinsics"][None])


def rel(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def test_v1_port_matches_reference_from_one_plan():
    torch.set_num_threads(2)
    cell = tiny_cell(V1)
    plan, _ = harness.plans(cell)
    port = harness.make_encoder(cell, "port", plan, SEED, CPU).eval()
    ref = harness.make_encoder(cell, "reference", plan, SEED, CPU).eval()
    req = traffic_gen.request(cell.traffic, SEED, 0, CPU)
    p, r = forward(port, req), forward(ref, req)
    assert p["variant"] == r["variant"] == "spfsplat"
    pairs = {k: (p[k], r[k])
             for k in ("pts3d", "extrinsics_c", "extrinsics_cwt")}
    pairs.update({f"gaussians.{k}": (getattr(p["gaussians"], k),
                                     getattr(r["gaussians"], k))
                  for k in ("means", "covariances", "harmonics",
                            "opacities")})
    # The poses move off the identity (fc_t keeps its LeCun draw), so
    # the comparison sees the translation heads.
    assert float((r["extrinsics_cwt"][0, 1:, :3, 3]).norm()) > 0.1
    for name, (a, b) in pairs.items():
        assert a.shape == b.shape, name
        assert rel(a, b) < FORWARD_TOL, (name, rel(a, b))


def test_v1_plan_names_are_the_port_parameters():
    cell = harness.load_cell(V1)
    plan, _ = harness.plans(cell)
    with torch.device("meta"):
        port = harness.resolve(cell.config["port"]["encoder"])(harness.build(
            harness.resolve(cell.config["port"]["config"]),
            cell.config["encoder"]))
    params = dict(port.named_parameters())
    assert [l.name for l in plan] == sorted(params)
    assert all(l.shape == tuple(params[l.name].shape) for l in plan)
    assert sum(p.numel() for p in params.values()) == \
        cell.config["parameters"] == 611_300_672


def test_v1_config_is_the_preset_as_composed():
    """The configuration file's encoder is `experiments/spfsplat/
    re10k.yaml` as the port composes it (the recipe's defaults)."""
    cfg = load_config([ROOT / "experiments/spfsplat/re10k.yaml"],
                      ["checkpointing.pretrained_weights=null"])
    assert cfg.encoder.name == "spfsplat"
    as_json = json.loads(json.dumps(dataclasses.asdict(cfg.encoder.spfsplat)))
    assert as_json == harness.load_cell(V1).config["encoder"]


@pytest.mark.parametrize("workload", [V1, "v2l-serve-224"])
def test_new_serve_cells_run_through_the_harness(workload):
    torch.set_num_threads(2)
    cell = tiny_cell(workload)
    out = harness.run_cell(cell, SEED, 0.0, True, CPU, 0.0,
                           log=lambda s: None)
    assert out.failed == 0 and out.readings.items >= 1
    assert out.numbers and all(v < HARNESS_TOL
                               for v in out.numbers.values()), out.numbers
    got = harness.metrics_of(cell, out.readings, True)
    assert {"serve.encoder_ms", "serve.decoder_ms"} <= set(got)
    # No device on the CPU: K5's share reads nothing.
    assert "k5_fwd_roofline.v1" not in got
    if workload == V1:
        logits = masked_logits(cell.config, cell.traffic)
        assert out.readings.launches["masked_attn_logits"] == logits
        assert got["serve.masked_logits_gib"]["value"] == logits * 4 / 2**30
    else:
        assert "serve.masked_logits_gib" not in {m["name"]
                                                 for m in cell.per_layer}


@pytest.mark.parametrize("n_q,chunked_min_kv", [(12, 1024), (8, 4)])
def test_masked_attn_logits_counts_both_branches(n_q, chunked_min_kv):
    """The dense branch (12 keys, under a threshold of 1024) and the
    query-chunked one (8 queries in chunks of 4, at 12 keys over a
    threshold of 4) each add b h n_q n_k, and give the same attention."""
    gen = torch.Generator().manual_seed(0)
    l = 4
    q = torch.randn(2, 3, n_q, 8, generator=gen)
    k = torch.randn(2, 3, 3 * l, 8, generator=gen)
    v = torch.randn(2, 3, 3 * l, 8, generator=gen)
    mask = torch.tensor([[0.0, float("-inf"), 0.0],
                         [0.0, 0.0, float("-inf")],
                         [float("-inf"), 0.0, 0.0]])[: n_q // l]
    cuda_lib.reset_launch_counts()
    out = attention.sdpa_view_masked(q, k, v, 0.3, mask, l, chunk_q=4,
                                     chunked_min_kv=chunked_min_kv)
    assert cuda_lib.launch_counts["masked_attn_logits"] == 2 * 3 * n_q * 3 * l
    assert not any(cuda_lib.launches().values())
    dense = attention.sdpa_view_masked(q, k, v, 0.3, mask, l, chunk_q=4,
                                       chunked_min_kv=10**6)
    torch.testing.assert_close(out, dense, rtol=1e-6, atol=1e-6)
    assert cuda_lib.launch_counts["masked_attn_logits"] == \
        2 * (2 * 3 * n_q * 3 * l)


@pytest.mark.parametrize("flash_min_kv", [1, 10**4])
def test_roofline_v1_shapes_are_the_flash_calls(monkeypatch, flash_min_kv):
    """With K5's threshold patched to the tiny encoder's token count, the
    forward sends every self-attention down the flash branch (the dense
    form on the CPU) in the order `roofline_v1` lists them; at a
    threshold above it, none, and the list is empty."""
    torch.set_num_threads(2)
    cell = tiny_cell(V1)
    plan, _ = harness.plans(cell)
    port = harness.make_encoder(cell, "port", plan, SEED, CPU).eval()
    calls = []
    real = attention.flash_attention

    def watch(q, k, v, scale):
        calls.append((*q.shape[:3], k.shape[2], q.shape[3]))
        return real(q, k, v, scale)

    monkeypatch.setattr(attention, "flash_attention", watch)
    monkeypatch.setattr(attention, "FLASH_MIN_KV", flash_min_kv)
    monkeypatch.setattr(roofline, "FLASH_MIN_KV", flash_min_kv)
    forward(port, traffic_gen.request(cell.traffic, SEED, 0, CPU))
    want = roofline_v1.k5_forward_shapes(cell.config, cell.traffic)
    assert calls == want
    assert len(want) == (0 if flash_min_kv > 5 else 2 + 2 * 2 * 2)


def test_roofline_v1_counts_72_launches_at_1024():
    cell = harness.load_cell(V1)
    shapes = roofline_v1.k5_forward_shapes(cell.config, cell.traffic)
    assert len(shapes) == 72
    assert shapes[:24] == [(3, 16, 4097, 4097, 64)] * 24
    dec = [(1, 12, 4097, 4097, 64), (1, 12, 4097, 4097, 64)] * 12
    dec += [(1, 12, 4097, 4097, 64), (2, 12, 4097, 4097, 64)] * 12
    assert shapes[24:] == dec
    assert masked_logits(cell.config, cell.traffic) == 31_422_285_648


REFERENCE_V1 = ("portbench/reference/models/croco/backbone_multi.py",
                "portbench/reference/models/encoder_spfsplat.py")


def test_v1_reference_imports_no_port_or_jax():
    """Neither file names a port or JAX module, and importing them alone
    loads none (`harness.forbidden_modules`, and the port's package)."""
    for path in REFERENCE_V1:
        names = set()
        for node in ast.walk(ast.parse((ROOT / path).read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add(node.module.split(".")[0])
        assert names <= {"__future__", "dataclasses", "torch", "portbench"}, \
            (path, names)
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.models.encoder_spfsplat; "
            "from portbench import harness; "
            "print(harness.forbidden_modules(), "
            "sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'spfsplatv2_tpu_torch'))") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def _trace(launches: int, items: int = 2):
    """A traced segment whose device trace holds `launches` of the
    view-masked kernel beside a K5 forward."""
    from portbench import trace as trace_mod

    device = [(0, 10, "view_masked_fwd_kernel")] * launches
    return trace_mod.Trace(window_s=1.0, items=items,
                           device=device + [(0, 5, "flash_forward_kernel")])


@pytest.mark.parametrize("workload,name,calls", [
    ("v2-serve-1024", "serve.masked_flash_share", 24),
    ("v1-serve-1024", "serve.masked_flash_share.v1", 48),
])
@pytest.mark.parametrize("case", ["all", "half", "none", "untraced",
                                  "256px", "float32"])
def test_masked_flash_share_readers(workload, name, calls, case):
    """The readers of the view-masked kernel's share: its launches in the
    device trace a traced request over the decoders' cross-attention calls
    with FLASH_MIN_KV keys or more (the flagship's 2 x 12 over 3 x 4,098
    keys; v1's 4 x 12 over 2 x and 3 x 4,097), in %; nothing without a
    trace, without a launch of the kernel (a program without it), or
    where no call reaches the threshold (256^2: 774 and 771 keys) or the
    decoders are not bf16."""
    from portbench import view_masked

    cell = harness.load_cell(workload)
    config, traffic = cell.config, cell.traffic
    counter = (view_masked.flagship_calls if name.endswith("share")
               else view_masked.v1_calls)
    assert counter(config, traffic) == calls
    if case == "256px":
        traffic = {**traffic, "image_size": 256}
    if case == "float32":
        config = merge(config, {"encoder": {"backbone": {
            "compute_dtype": "float32"}}})
    launches = {"all": calls, "half": calls // 2, "none": 0}.get(case, calls)
    r = harness.Readings("serve", config, traffic, 0.0, 1.0, 2, 2, [], {},
                         None, None, {},
                         None if case == "untraced" else _trace(2 * launches))
    want = {"all": 100.0, "half": 50.0}.get(case)
    assert harness.load_metric(name)(r) == want
