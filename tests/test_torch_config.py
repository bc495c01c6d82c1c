"""The port's configuration vs the JAX package's on the CPU.

Every preset under `experiments/` goes through the port's YAML reader
(held against `yaml.safe_load`, object for object) and through both
packages' `load_config` with the same overrides (held as nested dicts).
"""

import sys
from pathlib import Path

import pytest
import yaml

from spfsplatv2_tpu.config import _to_dict as j_to_dict
from spfsplatv2_tpu.config import load_config as j_load_config
from spfsplatv2_tpu_torch import config
from spfsplatv2_tpu_torch.models import get_encoder
from spfsplatv2_tpu_torch.utils import yaml_lite

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import vggt_encoder_overrides  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PRESETS = sorted(str(p.relative_to(REPO))
                 for p in (REPO / "experiments").rglob("*.yaml"))
OVERRIDES = [
    "mode=test",
    "dataset.roots=[/data/x, /data/y]",
    "dataset.original_image_shape=[32,32]",
    "optimizer.lr=0.0005",
    "optimizer.weight_decay=1e-4",       # a string to YAML 1.1, coerced
    "trainer.hbm_budget_gb=24",
    "trainer.microbatch=4",
    "checkpointing.pretrained_weights=null",
    "checkpointing.load='outputs/run #1/step_0'",
    "test.save_image=false",
    "encoder.spfsplatv2.backbone.compute_dtype=float32",
    "encoder.spfsplatv2.dpt_layer_dims=[8,16,24,32]",
    "decoder.rasterizer.entry_budget_factor=1.0e10",
    "image_shape=[32, 32]",
]


def test_every_preset_is_listed():
    assert len(PRESETS) == 19
    assert {Path(p).parent.name for p in PRESETS} == {
        "spfsplat", "spfsplatv2", "spfsplatv2-l"}


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_matches_jax(preset):
    path = REPO / preset
    text = path.read_text()
    assert yaml_lite.safe_load(text) == yaml.safe_load(text)
    overrides = list(OVERRIDES)
    if "datasets:" in text:
        # A list-index override into a multi-dataset recipe.
        overrides += ["datasets.0.dataset.roots=['/data/re10k']",
                      "datasets.1.view_sampler.warm_up_steps=7"]
    ours = config._to_dict(config.load_config([path], overrides))
    assert ours == j_to_dict(j_load_config([path], overrides))
    if "datasets:" in text:
        assert ours["datasets"][0]["dataset"]["roots"] == ["/data/re10k"]


@pytest.mark.parametrize("text", [
    "1.0e10", "1.0e+10", "1e-4", "0.0005", "-1", "+7", "1_000", ".5", "-.inf",
    ".nan", "null", "~", "", "true", "False", "yes", "Off", "[32,32]",
    "[32, 32,]", "[]", "[/data/x]", "['/data/x']", '["a", b]', "'it''s'",
    "plain words", "a:b", "facebook/VGGT-1B", "x # comment",
    "outputs/test/spfsplatv2",
])
def test_scalars_match_pyyaml(text):
    got, want = yaml_lite.safe_load(text), yaml.safe_load(text)
    if want != want:        # nan
        assert got != got
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("text", [
    "0x1f", "017", "1:30", "2001-12-14", "&a x", "*a", "!!str x", "{a: 1}",
    "[[1]]", "a: |\n  x", "---\na: 1", "a: 1\na: 2", "a:\n\tb: 1",
])
def test_unsupported_yaml_raises(text):
    with pytest.raises(yaml_lite.YAMLError):
        yaml_lite.safe_load(text)


def test_nested_blocks_match_pyyaml():
    text = (
        "a:\n  b: 1\n  c:\n  - x\n  - name: y  # note\n    d: [1, 2]\n"
        "  - - 3\n    - 4\ne: 'q # not a comment'\nf:\n"
    )
    assert yaml_lite.safe_load(text) == yaml.safe_load(text)


def test_sampler_switches_to_evaluation_at_test(tmp_path):
    from spfsplatv2_tpu_torch.data.view_samplers import (
        BoundedViewSampler,
        EvaluationViewSampler,
    )

    index = tmp_path / "index.json"
    index.write_text('{"s": {"context": [0, 4], "target": [2]}}')
    cfg = config.load_config(
        [REPO / "experiments/spfsplatv2/re10k.yaml"],
        [f"evaluation_sampler.index_path={index}"])
    assert isinstance(config.make_sampler_from_config(cfg, "train"),
                      BoundedViewSampler)
    sampler = config.make_sampler_from_config(cfg, "test")
    assert isinstance(sampler, EvaluationViewSampler)
    assert [list(x) for x in sampler.sample("s", 10)] == [[0, 4], [2]]


@pytest.mark.parametrize("name,item", [("spfsplat", "17"),
                                       ("spfsplatv2l", "16")])
def test_unported_encoders_raise(name, item):
    """Both encoders that were once not ported (ROADMAP.md items 16 and
    17) are: the registry builds each from overrides, at the tiny sizes
    of tests/test_torch_vggt.py and tests/test_torch_v1.py."""
    if name == "spfsplatv2l":
        from spfsplatv2_tpu_torch.models.encoder_vggt import SPFSplatV2LEncoder

        cfg = config.load_config(None, vggt_encoder_overrides())
        encoder = get_encoder(cfg.encoder, device="cpu")
        assert isinstance(encoder, SPFSplatV2LEncoder)
        assert encoder.aggregator.cfg.dinov2.embed_dim == 32
        assert len(encoder.aggregator.frame_blocks) == 2
        return
    from spfsplatv2_tpu_torch.models.encoder_spfsplat import SPFSplatEncoder

    ov = [f"encoder.name={name}", "encoder.spfsplat.sh_degree=1",
          "encoder.spfsplat.dpt_feature_dim=32",
          "encoder.spfsplat.dpt_last_dim=16",
          "encoder.spfsplat.dpt_layer_dims=[16,24,32,48]"]
    ov += [f"encoder.spfsplat.backbone.{k}={v}"
           for k, v in dict(enc_depth=2, enc_embed_dim=64, enc_num_heads=4,
                            dec_depth=2, dec_embed_dim=48,
                            dec_num_heads=4).items()]
    encoder = get_encoder(config.load_config(None, ov).encoder, device="cpu")
    assert isinstance(encoder, SPFSplatEncoder)
    assert len(encoder.backbone.enc_blocks) == 2
    assert len(encoder.backbone.dec_blocks2) == 2
    assert encoder.pose_head2.mlp1.in_features == 64 + 48


def test_unknown_key_raises():
    with pytest.raises(KeyError, match="no_such_key"):
        config.load_config(None, ["trainer.no_such_key=1"])
