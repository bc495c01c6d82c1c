"""The port's memory guard and checkpoints.

The guard's halving and its `HBMBudgetError` run with a stubbed peak
reader (off the card the probe reads nothing; test_torch_kernels.py
holds the real probe on the card to its promise of moving nothing).  Save, load and
resume are held exact, and a JAX train state converted by
`utils/from_flax.py` resumes as the JAX optimizer does.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from spfsplatv2_tpu.training import optim as joptim
from spfsplatv2_tpu_torch.config import load_config
from spfsplatv2_tpu_torch.data.synthetic import write_synthetic_dataset
from spfsplatv2_tpu_torch.models.croco.backbone import CrocoBackboneConfig
from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config, build_encoder
from spfsplatv2_tpu_torch.training import loop
from spfsplatv2_tpu_torch.training.optim import Optimizer, OptimizerConfig
from spfsplatv2_tpu_torch.training.step import (
    HBMBudgetError,
    LossConfig,
    init_train_state,
)
from spfsplatv2_tpu_torch.utils.from_flax import (
    checkpoint_from_flax,
    flax_to_state_dict,
)
from spfsplatv2_tpu_torch.utils.reference_checkpoint import reference_state_dict

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    TINY_BACKBONE,
    TINY_HEADS,
    jax_tiny_encoder,
    random_flax_params,
    tiny_teacher_loader,
    torch_tiny_encoder,
)


def tiny_state(device="cpu", seed=0, **opt):
    enc = build_encoder(SPFSplatV2Config(
        backbone=CrocoBackboneConfig(**TINY_BACKBONE), **TINY_HEADS),
        seed=seed, device=device)
    optimizer = Optimizer(OptimizerConfig(warm_up_steps=3, **opt),
                          enc.named_parameters())
    return init_train_state(enc, optimizer)


def apply_grads(state, seed, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    for p in state.optimizer.params:
        p.grad = (scale * torch.randn(p.shape, generator=gen)).to(p.device)
    state.optimizer.step()
    state.step += 1


def test_fit_microbatch_halves_then_raises(capsys):
    probed = []

    def probe(mb):
        probed.append(mb)
        return 99.0

    with pytest.raises(HBMBudgetError, match="cannot halve further"):
        loop.fit_microbatch(probe, 8, None, 1e-6)
    assert probed == [8, 4, 2, 1]
    out = capsys.readouterr().out
    assert "halving accumulation microbatch 8 -> 4" in out
    assert "halving accumulation microbatch 2 -> 1" in out
    # An odd batch cannot halve evenly.
    with pytest.raises(HBMBudgetError):
        loop.fit_microbatch(lambda mb: 99.0, 6, None, 1.0)


def test_fit_microbatch_settles_and_passes_without_a_reading(capsys):
    assert loop.fit_microbatch(lambda mb: float(mb), 16, None, 5.0) == (4, 4.0)
    assert loop.fit_microbatch(lambda mb: float(mb), 16, 8, 9.0) == (8, 8.0)
    out = capsys.readouterr().out
    assert "train step peak HBM 16.00 GB (budget 5.0 GB)" in out
    assert "halving accumulation microbatch 16 -> 8" in out
    # Off the card the probe reads nothing and the guard stands aside.
    assert loop.fit_microbatch(lambda mb: None, 16, None, 5.0) == (None, None)
    assert loop.fit_microbatch(lambda mb: 99.0, 16, None, None) == (None, 99.0)


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    write_synthetic_dataset(root, 2, 8, (32, 32), "train")
    return root


def _tiny_cfg(root, out, budget):
    ov = [f"dataset.roots=['{root}']", "dataset.original_image_shape=[32,32]",
          "dataset.input_image_shape=[32,32]", "image_shape=[32,32]",
          "trainer.batch_size=4", f"trainer.hbm_budget_gb={budget}",
          "trainer.val_check_interval=0", "loss.use_lpips=false",
          "checkpointing.every_n_train_steps=0", f"output_dir={out}",
          "view_sampler.warm_up_steps=0",
          "view_sampler.min_distance_between_context_views=2",
          "view_sampler.max_distance_between_context_views=6"]
    for k, v in TINY_BACKBONE.items():
        ov.append(f"encoder.spfsplatv2.backbone.{k}={v}")
    for k, v in TINY_HEADS.items():
        ov.append(f"encoder.spfsplatv2.{k}={list(v) if isinstance(v, tuple) else v}")
    return load_config(None, ov)


def test_guard_in_run_training(train_root, tmp_path, monkeypatch):
    """run_training probes the full batch, halves, and builds its step
    at the microbatch the guard chose; over any budget it stops before
    the first step."""
    probed, built = [], []
    monkeypatch.setattr(loop, "probe_peak_gb",
                        lambda state, batch, mb, kw: probed.append(mb) or mb / 2)
    real = loop.make_train_step

    def record(*args, microbatch=None, **kwargs):
        built.append(microbatch)
        return real(*args, microbatch=microbatch, **kwargs)

    monkeypatch.setattr(loop, "make_train_step", record)
    result = loop.run_training(_tiny_cfg(train_root, tmp_path, 1.5),
                               max_steps=1, device="cpu")
    assert probed == [4, 2] and built == [2]
    assert result["guard"]["microbatch"] == 2
    assert result["guard"]["peak_gb"] == 1.0
    assert result["state"].step == 1
    assert np.isfinite(result["metrics"]["loss/total"])
    probed.clear()
    with pytest.raises(HBMBudgetError):
        loop.run_training(_tiny_cfg(train_root, tmp_path, 0.1), max_steps=1,
                          device="cpu")
    assert probed == [4, 2, 1] and built == [2]


def test_multi_dataset_training_concatenates(tmp_path, monkeypatch):
    """The two-dataset preset draws one batch of each entry a step and
    trains on their concatenation."""
    root = tmp_path / "ds"
    write_synthetic_dataset(root, 2, 30, (32, 32), "train")
    ov = [f"output_dir={tmp_path}", "trainer.batch_size=2",
          "trainer.val_check_interval=0", "loss.use_lpips=false",
          "checkpointing.pretrained_weights=null",
          "checkpointing.every_n_train_steps=0", "image_shape=[32,32]"]
    for i in (0, 1):
        ov += [f"datasets.{i}.dataset.roots=['{root}']",
               f"datasets.{i}.dataset.original_image_shape=[32,32]",
               f"datasets.{i}.dataset.input_image_shape=[32,32]"]
    for k, v in TINY_BACKBONE.items():
        ov.append(f"encoder.spfsplatv2.backbone.{k}={v}")
    for k, v in TINY_HEADS.items():
        ov.append(f"encoder.spfsplatv2.{k}={list(v) if isinstance(v, tuple) else v}")
    cfg = load_config([Path(__file__).resolve().parents[1]
                       / "experiments/spfsplatv2/re10k_dl3dv.yaml"], ov)
    sizes = []
    real = loop.make_train_step

    def record(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda state, batch: (sizes.append(
            batch["context"]["image"].shape[0]) or step(state, batch))

    monkeypatch.setattr(loop, "make_train_step", record)
    result = loop.run_training(cfg, max_steps=2, device="cpu")
    assert sizes == [4, 4] and result["state"].step == 2


def test_unported_options_raise(train_root, tmp_path, monkeypatch):
    """Both options that were once not ported (ROADMAP.md items 17 and
    18) are: `checkpointing.pretrained_weights` loads a random
    MASt3R-keyed file into the encoder (what it lacks keeps its seeded
    init), and `train.distiller=mast3r` trains with the teacher (the tiny
    one) for the steps up to `distill_max_steps`."""
    from spfsplatv2_tpu_torch.utils.ckpt_convert import (
        convert_spfsplat_checkpoint,
    )

    cfg = _tiny_cfg(train_root, tmp_path, 1.0)
    sd = reference_state_dict(
        3, enc_depth=2, enc_dim=64, dec_depth=2, dec_dim=48,
        layer_dims=TINY_HEADS["dpt_layer_dims"],
        feature_dim=TINY_HEADS["dpt_feature_dim"],
        last_dim=TINY_HEADS["dpt_last_dim"])
    weights = tmp_path / "mast3r.pth"
    torch.save({"model": sd, "args": "the training arguments"}, weights)
    tiny_teacher_loader(monkeypatch)
    seeded = build_encoder(SPFSplatV2Config(
        backbone=CrocoBackboneConfig(**TINY_BACKBONE), **TINY_HEADS),
        seed=cfg.trainer.seed, device="cpu").state_dict()
    for ov in (f"checkpointing.pretrained_weights={weights}",
               "train.distiller=mast3r"):
        run = load_config(None, [ov, "train.distill_max_steps=5"], base=cfg)
        if "pretrained" in ov:
            result = loop.run_training(run, max_steps=0, device="cpu")
            own = result["encoder"].state_dict()
            converted = convert_spfsplat_checkpoint(sd, 2, 2)
            assert all(torch.equal(own[k], v) for k, v in converted.items())
            kept = [k for k in own if k not in converted]
            assert kept and all(torch.equal(own[k], seeded[k]) for k in kept)
        else:
            result = loop.run_training(run, max_steps=1, device="cpu")
            assert np.isfinite(result["metrics"]["loss/distillation"])
            assert result["state"].step == 1


def _assert_states_equal(a, b):
    sa, sb = a.encoder.state_dict(), b.encoder.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    ca, cb = loop.checkpoint_dict(a), loop.checkpoint_dict(b)
    for key in ("step", "count", "skipped_count"):
        assert ca[key] == cb[key], key
    for key in ("mu", "nu"):
        assert set(ca[key]) == set(cb[key])
        for k in ca[key]:
            assert torch.equal(ca[key][k], cb[key][k]), (key, k)


def test_save_load_resume_round_trip_is_exact(tmp_path):
    state = tiny_state()
    for i, scale in enumerate((1e-3, float("nan"), 1e-3)):  # one skipped
        apply_grads(state, i, scale)
    assert (state.step, state.optimizer.count, state.optimizer.skipped_count) == (3, 2, 1)
    ckpt_dir = tmp_path / "checkpoints"
    fresh = tiny_state(seed=1)
    path = loop.save_checkpoint(ckpt_dir, fresh, 1)        # an older one
    assert path == ckpt_dir.absolute() / "step_1" / "state.pt"
    loop.save_checkpoint(ckpt_dir, state, 3)
    assert not list(ckpt_dir.rglob("*.tmp"))
    resumed, step = loop.restore_latest_checkpoint(ckpt_dir, tiny_state(seed=2))
    assert step == 3
    _assert_states_equal(resumed, state)
    # The next update is the same on both: moments, count and schedule.
    apply_grads(state, 7, 1e-3)
    apply_grads(resumed, 7, 1e-3)
    _assert_states_equal(resumed, state)
    # A fresh state (no update yet) round-trips with no moments.
    restored = loop.restore_state(tiny_state(seed=3),
                                  loop.load_checkpoint(ckpt_dir / "step_1"))
    _assert_states_equal(restored, fresh)
    assert not restored.optimizer.adamw.state
    assert loop.restore_latest_checkpoint(tmp_path / "none", state) is None


def _adam_moments(opt_state, params):
    """optax's label-group moments merged into one param-shaped tree."""
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 2      # the "new" and "pretrained" groups
    merged = []
    for field in ("mu", "nu"):
        trees = [getattr(s, field) for s in adam]
        merged.append(jax.tree.map(
            lambda _, *xs: next(np.asarray(x) for x in xs
                                if not isinstance(x, optax.MaskedNode)),
            params, *trees,
            is_leaf=lambda x: isinstance(x, optax.MaskedNode)))
    assert int(adam[0].count) == int(adam[1].count)
    return merged[0], merged[1], int(adam[0].count)


def test_checkpoint_from_flax_resumes_like_jax():
    """A JAX train state after one update, converted, takes the next
    update exactly as JAX's optimizer does."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (1, 2, 32, 32, 3)).astype(np.float32)
    k = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3))
    params = random_flax_params(jax_tiny_encoder(), 4, img, k, img[:, :1],
                                k[:, :1])
    cfg = joptim.OptimizerConfig(warm_up_steps=3)
    jopt = joptim.make_optimizer(cfg, params)
    grads = [jax.tree.map(lambda x: (1e-3 * rng.standard_normal(x.shape))
                          .astype(np.float32), params) for _ in range(2)]
    opt_state = jopt.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        upd, opt_state = jopt.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state

    params, opt_state = update(grads[0], opt_state, params)
    mu, nu, count = _adam_moments(opt_state, params)

    ckpt = checkpoint_from_flax(jax.device_get(params), mu, nu, count, step=1,
                                skipped_count=int(opt_state.skipped_count))
    enc = torch_tiny_encoder(random_flax_params(jax_tiny_encoder(), 9, img, k,
                                                img[:, :1], k[:, :1]))
    state = init_train_state(enc, Optimizer(OptimizerConfig(warm_up_steps=3),
                                            enc.named_parameters()))
    loop.restore_state(state, ckpt)
    assert (state.step, state.optimizer.count) == (1, 1)

    params, opt_state = update(grads[1], opt_state, params)
    named = dict(enc.named_parameters())
    for name, g in flax_to_state_dict(grads[1]).items():
        named[name].grad = g.clone()
    assert state.optimizer.step()
    want = flax_to_state_dict(jax.device_get(params))
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
