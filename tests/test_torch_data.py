"""The port's data pipeline vs the JAX package's, for exact equality.

The same synthetic chunks (written by each package's own writer, held
byte for byte) go through both `ChunkedSceneDataset`s at every stage and
sampler, with augmentation on, and through `batch_iterator`,
`random_drop_views`, `collate` and `concat_batches`.
"""

import json

import numpy as np
import pytest

from spfsplatv2_tpu.data import dataset as jdataset
from spfsplatv2_tpu.data import synthetic as jsynthetic
from spfsplatv2_tpu.data import view_samplers as jsamplers
from spfsplatv2_tpu.training import loop as jloop
from spfsplatv2_tpu_torch.data import dataset, synthetic, view_samplers
from spfsplatv2_tpu_torch.training import loop

HW = (36, 64)
SAMPLER = dict(num_context_views=3, num_target_views=2,
               min_distance_between_context_views=6,
               max_distance_between_context_views=12,
               warm_up_steps=10, initial_min_distance_between_context_views=3,
               initial_max_distance_between_context_views=5)


def assert_tree_equal(a, b, path="batch"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Chunks written by the port; the JAX writer's are held equal."""
    base = tmp_path_factory.mktemp("data")
    for stage, scenes, frames in (("train", 3, 16), ("val", 2, 16),
                                  ("test", 2, 14)):
        synthetic.write_synthetic_dataset(base / "torch", scenes, frames, HW,
                                          stage)
        jsynthetic.write_synthetic_dataset(base / "jax", scenes, frames, HW,
                                           stage)
    (base / "torch" / "index.json").write_text(json.dumps({
        "scene_000": {"context": [0, 9], "target": [3, 5], "overlap": 0.2},
        "scene_001": {"context": [1, 13], "target": [7, 2], "overlap": 0.7},
    }))
    return base


def test_synthetic_chunks_are_byte_identical(root, tmp_path):
    for stage in ("train", "val", "test"):
        ours = (root / "torch" / stage / "000000.torch").read_bytes()
        assert ours == (root / "jax" / stage / "000000.torch").read_bytes()
    # Rendering in worker processes writes the same bytes.
    synthetic.write_synthetic_dataset(tmp_path, 2, 3, (20, 24), processes=2)
    jsynthetic.write_synthetic_dataset(tmp_path / "j", 2, 3, (20, 24))
    assert ((tmp_path / "train" / "000000.torch").read_bytes()
            == (tmp_path / "j" / "train" / "000000.torch").read_bytes())


def _pair(root, stage, kind, seed=0, **ds):
    """The same dataset built by both packages."""
    cfgs = {}
    for mod, smod in ((jdataset, jsamplers), (dataset, view_samplers)):
        dcfg = mod.DatasetConfig(roots=(str(root / "torch"),),
                                 input_image_shape=(32, 32),
                                 original_image_shape=HW, **ds)
        if kind == "evaluation":
            scfg = smod.EvaluationSamplerConfig(
                index_path=str(root / "torch" / "index.json"),
                num_context_views=3)
        else:
            scfg = smod.BoundedSamplerConfig(**SAMPLER)
        sampler = smod.make_view_sampler(kind, scfg, stage=stage)
        cfgs[mod] = mod.ChunkedSceneDataset(dcfg, sampler, stage=stage,
                                            seed=seed)
    return cfgs[jdataset], cfgs[dataset]


@pytest.mark.parametrize("stage,kind,workers", [
    ("train", "bounded", 4), ("train", "bounded", 0), ("val", "bounded", 4),
    ("test", "bounded", 4), ("test", "evaluation", 2),
])
def test_dataset_epochs_match_jax(root, stage, kind, workers):
    jds, tds = _pair(root, stage, kind, seed=7, num_workers=workers,
                     augment=True)
    for epoch in (0, 1):
        for step in (0, 6, 20):
            want = list(jds.epoch(epoch, global_step=step))
            got = list(tds.epoch(epoch, global_step=step))
            assert len(got) == len(want) > 0
            assert_tree_equal(got, want)
    if kind == "evaluation":
        assert [e["context"]["overlap"] for e in got] == [0.2, 0.7]


# Without prefetching the curriculum reads the step as the loop sets it;
# the prefetch thread reads it whenever it runs ahead, so the step stays
# fixed there.
@pytest.mark.parametrize("prefetch,step_of", [(0, lambda n: 3 * n),
                                              (2, lambda n: 6)])
def test_batch_iterator_and_view_dropout_match_jax(root, prefetch, step_of):
    jds, tds = _pair(root, "train", "bounded", seed=3)
    step = {"n": 0}
    jit = jloop.batch_iterator(jds, 2, lambda: step["n"], prefetch)
    tit = loop.batch_iterator(tds, 2, lambda: step["n"], prefetch)
    flags = type("Flags", (), {"random_drop_context_views": True,
                               "random_drop_target_views": True})
    jrng, trng = np.random.default_rng(11), np.random.default_rng(11)
    for n in range(4):
        step["n"] = step_of(n)
        jb, tb = next(jit), next(tit)
        assert_tree_equal(tb, jb)
        jd = jloop.random_drop_views(jb, jrng, flags)
        td = loop.random_drop_views(tb, trng, flags)
        assert_tree_equal(td, jd)
        assert td["context_valid"][[0, -1]].tolist() == [1.0, 1.0]
        assert td["target_valid"].sum() >= 1


def test_collate_and_concat_match_jax(root):
    jds, tds = _pair(root, "test", "evaluation")
    jex, tex = list(jds.epoch(0)), list(tds.epoch(0))
    jb, tb = jdataset.collate(jex), dataset.collate(tex)
    assert_tree_equal(tb, jb)
    # Concatenating with a batch that has no "overlap" drops the key.
    jb2, tb2 = (dict(b, context={k: v for k, v in b["context"].items()
                                 if k != "overlap"}) for b in (jb, tb))
    jc = jdataset.concat_batches([jb, jb2])
    tc = dataset.concat_batches([tb, tb2])
    assert_tree_equal(tc, jc)
    assert "overlap" not in tc["context"] and len(tc["scene"]) == 4
