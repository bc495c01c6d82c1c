"""The port's pointmap distillation and checkpoint conversion vs the JAX
package on the CPU.

`normalize_pointcloud`, `regr3d_loss` (with its gradient), the DUSt3R
teacher, the distillation term of `compute_losses` with its gradients,
and both converters on seeded random state dicts with DUSt3R's and
MASt3R's key names, at the tiny sizes of tests/test_registry_wiring.py;
then the v1 preset's command line trains (with pretrained weights and
the teacher) and tests on the CPU.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spfsplatv2_tpu.geometry import pointcloud as jpointcloud
from spfsplatv2_tpu.losses import point as jpoint
from spfsplatv2_tpu.models.croco.backbone import (
    CrocoBackboneConfig as JCrocoBackboneConfig,
)
from spfsplatv2_tpu.models.decoder import DecoderConfig as JDecoderConfig
from spfsplatv2_tpu.models.distiller import DistillerConfig as JDistillerConfig
from spfsplatv2_tpu.models.distiller import Dust3RDistiller as JDistiller
from spfsplatv2_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from spfsplatv2_tpu.training import step as jstep
from spfsplatv2_tpu.utils import ckpt_convert as jconvert
from spfsplatv2_tpu_torch import main as tmain
from spfsplatv2_tpu_torch.data.synthetic import write_synthetic_dataset
from spfsplatv2_tpu_torch.geometry import pointcloud
from spfsplatv2_tpu_torch.losses import point
from spfsplatv2_tpu_torch.models.decoder import DecoderConfig
from spfsplatv2_tpu_torch.models.distiller import Dust3RDistiller, build_distiller
from spfsplatv2_tpu_torch.ops.rasterizer import RasterizerConfig
from spfsplatv2_tpu_torch.training import loop, step
from spfsplatv2_tpu_torch.training.optim import Optimizer, OptimizerConfig
from spfsplatv2_tpu_torch.utils import ckpt_convert
from spfsplatv2_tpu_torch.utils.from_flax import flax_to_state_dict
from spfsplatv2_tpu_torch.utils.reference_checkpoint import reference_state_dict

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train import make_batch, torch_batch  # noqa: E402
from test_torch_v1 import MULTI_BB, jax_v1, torch_v1  # noqa: E402
from torch_port_common import (  # noqa: E402
    TINY_BACKBONE,
    TINY_HEADS,
    TINY_TEACHER_BACKBONE,
    jax_tiny_encoder,
    random_flax_params,
    tiny_teacher_config,
    tiny_teacher_loader,
    to_torch,
    torch_tiny_encoder,
)

RTOL, ATOL = 1e-4, 1e-5
HW = (32, 32)
GLOBAL_STEP = 1000
V1_PRESET = str(Path(__file__).resolve().parents[1]
                / "experiments/spfsplat/re10k.yaml")


def close(actual, desired, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(desired),
                               rtol=rtol, atol=atol, err_msg=msg)


def pointmaps(seed, b=2, h=8, w=8):
    """Points in front of a camera, with far outliers past the quantiles."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-1, 1, (b, h, w, 2)),
                          rng.uniform(1, 4, (b, h, w, 1))], -1)
    pts[:, 0, 0] *= 50.0
    return pts.astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_normalize_pointcloud_matches_jax(masked):
    rng = np.random.default_rng(1)
    p1, p2 = pointmaps(1), pointmaps(2)
    v1 = v2 = None
    if masked:
        v1, v2 = (rng.uniform(size=p1.shape[:3]) > 0.3 for _ in range(2))
        v2[1] = False           # a row with every point of view 2 out
    jout = jpointcloud.normalize_pointcloud(p1, p2, "avg_dis", v1, v2)
    tv = [None if v is None else to_torch(v) for v in (v1, v2)]
    tout = pointcloud.normalize_pointcloud(to_torch(p1), to_torch(p2),
                                           "avg_dis", *tv)
    for a, b in zip(tout, jout):
        close(a.numpy(), b)
    j1, jn = jpointcloud.normalize_pointcloud(p1)
    t1, tn = pointcloud.normalize_pointcloud(to_torch(p1))
    close(t1.numpy(), j1)
    close(tn.numpy(), jn)
    with pytest.raises(ValueError, match="norm_mode"):
        pointcloud.normalize_pointcloud(to_torch(p1), norm_mode="median_dis")


@pytest.mark.parametrize("disable_view1", [False, True])
def test_regr3d_loss_and_grad_match_jax(disable_view1):
    """Quantile outliers, teacher confidence below 3 and the student's
    points at another scale; the gradient with respect to the student's
    points within 1e-4 of its max."""
    rng = np.random.default_rng(2)
    gt1, gt2 = pointmaps(3), pointmaps(4)
    pr1 = (2.0 * gt1 + 0.1 * rng.standard_normal(gt1.shape)).astype(np.float32)
    pr2 = (2.0 * gt2 + 0.1 * rng.standard_normal(gt2.shape)).astype(np.float32)
    c1, c2 = (rng.uniform(1, 6, gt1.shape[:3]).astype(np.float32)
              for _ in range(2))

    def jloss(a, b):
        return jpoint.regr3d_loss(gt1, gt2, a, b, c1, c2,
                                  disable_view1=disable_view1)

    jl, (jg1, jg2) = jax.value_and_grad(jloss, argnums=(0, 1))(pr1, pr2)
    t1, t2 = (to_torch(x).requires_grad_(True) for x in (pr1, pr2))
    tl = point.regr3d_loss(to_torch(gt1), to_torch(gt2), t1, t2,
                           to_torch(c1), to_torch(c2),
                           disable_view1=disable_view1)
    tl.backward()
    close(float(tl.detach()), float(jl), rtol=1e-5)
    for tg, jg in ((t1.grad, jg1), (t2.grad, jg2)):
        scale = float(np.abs(np.asarray(jg)).max())
        close(tg.numpy(), jg, rtol=0, atol=1e-4 * scale + 1e-12)
    # Identical pointmaps give zero.
    same = point.regr3d_loss(*(to_torch(x) for x in (gt1, gt2, gt1, gt2, c1, c2)))
    assert float(same) < 1e-6


@pytest.fixture(scope="module")
def teacher():
    jdist = JDistiller(JDistillerConfig(backbone=JCrocoBackboneConfig(
        **TINY_TEACHER_BACKBONE, remat=False)))
    images = np.random.default_rng(5).uniform(0, 1, (2, 2, *HW, 3)).astype(
        np.float32)
    params = random_flax_params(jdist, 6, images)
    # Confidence channels near 1 + e^0.7 ~ 3, so that the bar of 3 keeps
    # some points of each view and drops others.
    for n in (1, 2):
        bias = params["params"][f"downstream_head{n}"]["head_out"]["bias"]
        bias[3] += 0.7
    tdist = Dust3RDistiller(tiny_teacher_config())
    tdist.load_state_dict(flax_to_state_dict(params), strict=True)
    return jdist, params, tdist.requires_grad_(False).eval(), images


def test_distiller_matches_jax(teacher):
    jdist, params, tdist, images = teacher
    jouts = jax.jit(lambda p, x: {n: jdist.apply(p, x, n)
                                  for n in (True, False)})(params, images)
    for normalize, jout in jouts.items():
        with torch.no_grad():
            tout = tdist(to_torch(images), normalize)
        for key in ("pts3d", "conf"):
            close(tout[key].numpy(), jout[key], msg=f"{key} {normalize}")
    assert tout["conf"].min() >= 1.0
    with pytest.raises(ValueError, match="pairwise"):
        tdist(to_torch(images[:, :1]))
    built = build_distiller(tiny_teacher_config(), seed=3, device="cpu")
    assert not any(p.requires_grad for p in built.parameters())
    assert not built.training


@pytest.fixture(scope="module")
def v1_init():
    """The tiny v1 encoder's seeded flax params and JAX's param shapes."""
    jenc = jax_v1()
    return (random_flax_params(jenc, 0, *_views()),
            jax.eval_shape(jenc.init, jax.random.PRNGKey(0), *_views()))


@pytest.mark.parametrize("variant", ["spfsplatv2", "spfsplat"])
def test_distillation_step_matches_jax(teacher, v1_init, variant):
    """The flagship's or v1's tiny encoder with the teacher.  The
    distillation term of `compute_losses` (its value, and its gradient as
    the gradient with the teacher less the gradient without it) against
    JAX's term, `0.1 * regr3d_loss` of the student's points on the
    teacher's, as JAX's `compute_losses` forms it, within 1e-4 of each
    max; the other metrics are the teacher-free step's (held in
    test_torch_train.py and test_torch_v1.py).  Then one port train step
    of the flagship leaves the teacher bit for bit as it was, with no
    gradient (v1 trains with the teacher in the CLI test below)."""
    jdist, dparams, tdist, _ = teacher
    batch = make_batch(8)
    c, t = batch["context"], batch["target"]
    if variant == "spfsplatv2":
        jenc, port_encoder = jax_tiny_encoder(), torch_tiny_encoder
        params = random_flax_params(jenc, 9, c["image"], c["intrinsics"],
                                    t["image"], t["intrinsics"])
    else:
        jenc, port_encoder, params = jax_v1(), torch_v1, v1_init[0]

    def jterm(p):
        pseudo = jax.lax.stop_gradient(jdist.apply(dparams, c["image"][:, :2]))
        pts = jenc.apply(p, c["image"], c["intrinsics"], t["image"],
                         t["intrinsics"], global_step=GLOBAL_STEP)["pts3d"]
        g, conf = pseudo["pts3d"], pseudo["conf"]
        return 0.1 * jpoint.regr3d_loss(g[:, 0], g[:, 1], pts[:, 0], pts[:, 1],
                                        conf[:, 0], conf[:, 1])

    jvalue, jgrads = jax.jit(jax.value_and_grad(jterm))(params)
    dcfg = DecoderConfig(rasterizer=RasterizerConfig(entry_budget_factor=4.0,
                                                     chunk=64))
    runs = {}
    for name, dist in (("with", tdist), ("without", None)):
        tenc = port_encoder(params).train()
        loss, metrics = step.compute_losses(
            tenc, torch_batch(batch), GLOBAL_STEP, HW, dcfg,
            step.LossConfig(use_lpips=False), distiller=dist)
        loss.backward()
        runs[name] = metrics, {k: p.grad for k, p in tenc.named_parameters()}
    (with_m, with_g), (without_m, without_g) = runs["with"], runs["without"]
    assert set(with_m) == set(without_m) | {"loss/distillation"}
    distill = float(with_m["loss/distillation"])
    assert distill > 0
    np.testing.assert_allclose(distill, float(jvalue), rtol=1e-4)
    np.testing.assert_allclose(float(with_m["loss/total"]),
                               float(without_m["loss/total"]) + distill,
                               rtol=1e-6)
    for name, ref in flax_to_state_dict(jgrads).items():
        got = with_g[name] - without_g[name]
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                   atol=1e-4 * scale + 1e-12, err_msg=name)
    assert max(float(np.abs(np.asarray(g)).max())
               for g in jax.tree_util.tree_leaves(jgrads)) > 0

    if variant == "spfsplat":
        return
    tenc = port_encoder(params).train()
    before = {k: v.clone() for k, v in tdist.state_dict().items()}
    opt = Optimizer(OptimizerConfig(warm_up_steps=2), tenc.named_parameters())
    train = step.make_train_step(tenc, opt, HW, dcfg,
                                 step.LossConfig(use_lpips=False),
                                 distiller=tdist)
    _, metrics = train(step.init_train_state(tenc, opt), torch_batch(batch))
    assert np.isfinite(metrics["loss/distillation"])
    assert all(torch.equal(v, before[k]) for k, v in tdist.state_dict().items())
    assert all(p.grad is None for p in tdist.parameters())


def spfsplat_state_dict(seed):
    """A SPFSplat v1 checkpoint's state dict ("encoder." prefix,
    "backbone." trunk, Gaussian and pose heads) at the tiny sizes."""
    sd = reference_state_dict(seed, **STUDENT_DIMS, head_channels=3)
    gen = torch.Generator().manual_seed(seed + 1)
    out = {}
    for k, v in sd.items():
        out[f"encoder.{k}" if k.startswith("downstream_head")
            else f"encoder.backbone.{k}"] = v
        if k.startswith("downstream_head") and ".head." not in k:
            gs = k.replace("downstream_head", "gaussian_param_head")
            out[f"encoder.{gs}"] = torch.randn(v.shape, generator=gen)
    fd, gs_dim = TINY_HEADS["dpt_feature_dim"], 1 + 7 + 3 * 4
    d = MULTI_BB["enc_embed_dim"] + MULTI_BB["dec_embed_dim"]
    for n in (1, 2):
        p = f"encoder.gaussian_param_head{n}.dpt"
        for key, shape in ((f"{p}.input_merger.0.weight", (fd, 3, 7, 7)),
                           (f"{p}.input_merger.0.bias", (fd,)),
                           (f"{p}.head.0.weight", (fd, fd, 3, 3)),
                           (f"{p}.head.4.weight", (gs_dim, fd, 1, 1)),
                           (f"{p}.head.4.bias", (gs_dim,))):
            out[key] = torch.randn(shape, generator=gen)
        p = "encoder.pose_head" + ("" if n == 1 else "2")
        for name, n_in, n_out in (("more_mlps.0", d, d // 2),
                                  ("more_mlps.2", d // 2, d // 4),
                                  ("fc_t", d // 4, 4), ("fc_rot", d // 4, 6)):
            out[f"{p}.{name}.weight"] = torch.randn(n_out, n_in, generator=gen)
            out[f"{p}.{name}.bias"] = torch.randn(n_out, generator=gen)
    out["encoder.backbone.intrinsic_encoder.weight"] = torch.randn(
        MULTI_BB["enc_embed_dim"], 9, generator=gen)
    out["encoder.backbone.intrinsic_encoder.bias"] = torch.randn(
        MULTI_BB["enc_embed_dim"], generator=gen)
    return out


REF_DIMS = dict(enc_depth=2, enc_dim=64, dec_depth=2, dec_dim=48)
# The tiny student's DPT heads (the teacher's keep DUSt3R's widths).
STUDENT_DIMS = dict(REF_DIMS, layer_dims=TINY_HEADS["dpt_layer_dims"],
                    feature_dim=TINY_HEADS["dpt_feature_dim"],
                    last_dim=TINY_HEADS["dpt_last_dim"])
# JAX's converter maps the reference's `refinenet4.resConfUnit1`, which
# its DPT core lacks (the deepest fusion block has no skip input and the
# reference never calls it), so JAX's `merge_params` raises on every
# DUSt3R or MASt3R checkpoint; the port drops it.
DEAD_UNIT = ".core.refinenet4.resConfUnit1."


def jax_converted(tree):
    """JAX's converted tree in the port's names, and its dead unit's keys."""
    flat = flax_to_state_dict(tree)
    dead = {k for k in flat if DEAD_UNIT in k}
    return {k: v for k, v in flat.items() if k not in dead}, dead


@pytest.mark.parametrize("case", ["mast3r", "croco_patch14", "spfsplat"])
def test_spfsplat_converter_matches_jax(case, v1_init):
    """MASt3R's keys (a local-feature head the converters ignore), a
    checkpoint with one decoder and 14 x 14 patches (duplicated, and the
    patch embed resampled to 16), and a complete SPFSplat v1 checkpoint;
    each converted and merged over the tiny v1 encoder's seeded init."""
    if case == "spfsplat":
        sd = spfsplat_state_dict(10)
    else:
        sd = reference_state_dict(10, **STUDENT_DIMS,
                                  patch=14 if case == "croco_patch14" else 16)
        sd["downstream_head1.head_local_features.fc1.weight"] = torch.ones(2, 2)
        if case == "croco_patch14":
            sd = {k: v for k, v in sd.items() if "dec_blocks2" not in k}
    got = ckpt_convert.convert_spfsplat_checkpoint(
        sd, enc_depth=2, dec_depth=2)
    jtree = jconvert.convert_spfsplat_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, enc_depth=2, dec_depth=2)
    want, dead = jax_converted(jtree)
    assert set(got) == set(want)
    assert len(dead) == (16 if case == "spfsplat" else 8)   # 4 a DPT head
    for key, ref in want.items():
        if case == "croco_patch14" and key.startswith("backbone.patch_embed.proj.w"):
            assert got[key].shape == (64, 3, 16, 16)
            close(got[key].numpy(), ref.numpy(), rtol=1e-4, atol=1e-6, msg=key)
        else:
            assert torch.equal(got[key], ref), key
    assert got["downstream_head1.head_out.weight"].shape[0] == 3
    if case == "croco_patch14":
        assert torch.equal(got["backbone.dec_blocks2.1.mlp.fc1.weight"],
                           got["backbone.dec_blocks.1.mlp.fc1.weight"])

    params, jparams = v1_init
    enc = torch_v1(params)
    seeded = {k: v.clone() for k, v in enc.state_dict().items()}
    ckpt_convert.merge_params(enc, got)
    own = enc.state_dict()
    assert all(torch.equal(own[k], v) for k, v in got.items())
    assert all(torch.equal(own[k], seeded[k]) for k in own if k not in got)
    if case == "spfsplat":
        assert set(got) == set(own)            # a complete checkpoint
    else:
        assert any(k.startswith("pose_head1") for k in own if k not in got)
    # JAX's model has no dead unit for its converted one to land on, and
    # its `merge_params` nests the converted tree under a second "params"
    # and raises before it reaches any weight.
    assert "resConfUnit1" in jtree["downstream_head1"]["core"]["refinenet4"]
    assert "resConfUnit1" not in jparams["params"]["downstream_head1"]["core"][
        "refinenet4"]
    with pytest.raises(KeyError, match="/params not in model"):
        jconvert.merge_params(jparams, jtree)
    # The port's checks.
    with pytest.raises(KeyError, match="not in model"):
        ckpt_convert.merge_params(enc, {"backbone.nope.weight": torch.ones(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt_convert.merge_params(
            enc, {"backbone.enc_norm.weight": torch.ones(3)})


def _views():
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 1, (1, 3, *HW, 3)).astype(np.float32)
    k = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 3, 3, 3)).copy()
    return img[:, :2], k[:, :2], img[:, 2:], k[:, 2:]


def test_dust3r_converter_matches_jax(teacher):
    """DUSt3R's keys into the teacher: the confidence channel kept."""
    sd = reference_state_dict(12, **REF_DIMS)
    got = ckpt_convert.convert_dust3r_distiller_checkpoint(
        sd, enc_depth=2, dec_depth=2)
    want, dead = jax_converted(jconvert.convert_dust3r_distiller_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, enc_depth=2, dec_depth=2))
    assert set(got) == set(want) and dead
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert got["downstream_head2.head_out.weight"].shape[0] == 4
    tdist = Dust3RDistiller(tiny_teacher_config())
    ckpt_convert.merge_params(tdist, got)
    assert set(got) == set(tdist.state_dict())  # the whole teacher


def test_v1_preset_cli_trains_with_teacher_and_tests(tmp_path, monkeypatch):
    """`python -m spfsplatv2_tpu_torch.main --config
    experiments/spfsplat/re10k.yaml --device cpu` with tiny overrides:
    mode=train for 3 steps from a MASt3R-keyed file, with the teacher
    (converted from a DUSt3R-keyed file) for steps 0 and 1 (the steps up
    to `distill_max_steps`), then mode=test from the saved checkpoint."""
    root = tmp_path / "data"
    write_synthetic_dataset(root, 2, 30, (32, 32), "train")
    write_synthetic_dataset(root, 1, 12, (32, 32), "test")
    (root / "index.json").write_text(
        '{"scene_000": {"context": [0, 6], "target": [3], "overlap": 0.3}}')
    mast3r = tmp_path / "mast3r.pth"
    torch.save({"model": reference_state_dict(13, **STUDENT_DIMS), "args": "x"},
               mast3r)
    dust3r = tmp_path / "dust3r.pth"
    torch.save(reference_state_dict(14, **REF_DIMS), dust3r)
    out = tmp_path / "out"
    ov = [f"dataset.roots=['{root}']", "dataset.original_image_shape=[32,32]",
          "dataset.input_image_shape=[32,32]", "image_shape=[32,32]",
          f"output_dir={out}", f"test.output_path={out / 'test'}",
          f"evaluation_sampler.index_path={root / 'index.json'}",
          "trainer.batch_size=2", "trainer.max_steps=3",
          "trainer.val_check_interval=0", "loss.use_lpips=false",
          "checkpointing.every_n_train_steps=0",
          "train.print_log_every_n_steps=1", "test.save_image=false",
          f"checkpointing.pretrained_weights={mast3r}",
          "train.distiller=dust3r", f"train.distiller_weights={dust3r}",
          "train.distill_max_steps=1"]
    ov += [f"encoder.spfsplat.backbone.{k}={v}" for k, v in MULTI_BB.items()]
    ov += [f"encoder.spfsplat.{k}={list(v) if isinstance(v, tuple) else v}"
           for k, v in TINY_HEADS.items()]
    tiny_teacher_loader(monkeypatch)
    logged, loaded = {}, []
    real_run, real_load = loop.run_training, loop.load_pretrained_weights

    def run(cfg, log_fn=None, **kwargs):
        def log(s, m):
            logged[s] = m
            log_fn(s, m)

        return real_run(cfg, log_fn=log, **kwargs)

    def load(encoder, cfg, path):
        loaded.append(path)
        real_load(encoder, cfg, path)
        want = ckpt_convert.convert_spfsplat_checkpoint(
            torch.load(path, weights_only=False)["model"], 2, 2)
        own = encoder.state_dict()
        assert all(torch.equal(own[k], v) for k, v in want.items())
        return encoder

    monkeypatch.setattr(loop, "run_training", run)
    monkeypatch.setattr(loop, "load_pretrained_weights", load)
    argv = ["--config", V1_PRESET, "--device", "cpu", *ov]
    assert tmain.main(argv) == 0
    assert loaded == [str(mast3r)]
    assert ["loss/distillation" in logged[s] for s in range(3)] == [
        True, True, False]
    assert all(np.isfinite(m["loss/reproj_c2_only"]) for m in logged.values())
    ckpt = out / "checkpoints" / "step_-1"
    head = loop.load_checkpoint(ckpt)
    assert head["step"] == 3
    assert not any(k.startswith(("distiller", "teacher")) for k in head["encoder"])
    assert tmain.main(argv + ["mode=test", f"checkpointing.load={ckpt}"]) == 0
    import json

    scores = json.loads((out / "test" / "scores_all_avg.json").read_text())
    assert np.isfinite(scores["psnr"])
