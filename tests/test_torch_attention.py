"""The port's attention (`spfsplatv2_tpu_torch/ops/attention.py`) against
the JAX package on the CPU.

Above its key threshold `sdpa` takes flash attention (kernel K5 on CUDA
tensors, its plain version, the dense form, on CPU tensors).  These tests
send ragged lengths down that branch by passing `flash_min_kv` and hold
the output and its gradients against JAX's `sdpa` (dense on the CPU) and
against JAX's `flash_attention.mha_reference` on the inputs padded to
JAX's 512-row blocks with the segment ids JAX's `sdpa` builds, which
checks the padding contract: real queries see only the real keys.  Also
K5's plain versions (the references of its kernels on the card), the
query-chunked branch of `sdpa_view_masked`, and the tiny encoder through
`evaluate_example` with every self-attention on the flash branch.

Tolerances, as fractions of the reference's max |value|: float32 1e-5
(both sides compute in float32, in another order); bfloat16 8e-3 against
JAX's `sdpa` (both round the logits and the probabilities to bfloat16,
with different accumulation orders) and 3e-2 against `mha_reference`,
which also keeps the softmax numerator in bfloat16.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds,
    mha_reference,
)

from spfsplatv2_tpu.evaluation import evaluator as jeval
from spfsplatv2_tpu.models.croco.backbone import (
    build_cross_view_mask as jbuild_mask,
)
from spfsplatv2_tpu.models.decoder import DecoderConfig as JDecoderConfig
from spfsplatv2_tpu.ops import attention as jattn
from spfsplatv2_tpu.ops.rasterizer import RasterizerConfig as JRasterizerConfig
from spfsplatv2_tpu_torch.evaluation import evaluator
from spfsplatv2_tpu_torch.models.decoder import LONG_CONTEXT_DECODER
from spfsplatv2_tpu_torch.ops import attention, cuda_lib

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_slice import HW, make_example  # noqa: E402
from torch_port_common import (  # noqa: E402
    assert_images_close,
    jax_tiny_encoder,
    random_flax_params,
    torch_tiny_encoder,
)

SCALE = 64**-0.5
BLOCK = 512  # JAX's `sdpa` pads to this for its flash kernel
TOL_JAX = {"float32": 1e-5, "bfloat16": 8e-3}
TOL_REF = {"float32": 1e-5, "bfloat16": 3e-2}
SHAPES = [(300, 300), (389, 389), (300, 389)]


def _inputs(n_q, n_k, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, 3, n, 64)).astype(np.float32)
               for n in (n_q, n_k, n_k))
    do = rng.standard_normal((2, 3, n_q, 64)).astype(np.float32)
    return q, k, v, do


def _padded_reference(n_q, n_k, q_scale=1.0, sm_scale=SCALE):
    """`mha_reference` on inputs padded to BLOCK rows, fenced with the
    segment ids of JAX's `sdpa` (real 0, padding 1), cut back to n_q."""
    pad = lambda x, n: jnp.pad(x, ((0, 0), (0, 0), (0, BLOCK - n), (0, 0)))  # noqa: E731
    ids = lambda n: jnp.broadcast_to(  # noqa: E731
        (jnp.arange(BLOCK) >= n).astype(jnp.int32)[None], (2, BLOCK))
    seg = SegmentIds(q=ids(n_q), kv=ids(n_k))

    def f(q, k, v):
        out = mha_reference(pad(q * q_scale, n_q), pad(k, n_k), pad(v, n_k),
                            None, seg, sm_scale=sm_scale)
        return out[:, :, :n_q]

    return f


def _jit_in_f32(dtype, fn):
    """`jax.jit(fn)` in float32 (one compile instead of one per eager op);
    eager in bfloat16, where XLA's CPU fusions would keep intermediates in
    float32 that JAX's eager ops, like the port, round to bfloat16."""
    return jax.jit(fn) if dtype == "float32" else fn


def _rel_err(actual, desired):
    a = np.asarray(actual, np.float32)
    d = np.asarray(jnp.asarray(desired).astype(jnp.float32))
    return float(np.abs(a - d).max() / np.abs(d).max())


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the calls that take `sdpa`'s flash branch."""
    calls = []
    inner = attention.flash_attention

    def counting(*args):
        calls.append(args[0].shape)
        return inner(*args)

    monkeypatch.setattr(attention, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_q,n_k", SHAPES)
def test_sdpa_flash_branch_matches_jax(flash_calls, n_q, n_k, dtype):
    q, k, v, _ = _inputs(n_q, n_k)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    cuda_lib.reset_launch_counts()
    out = attention.sdpa(tq, tk, tv, SCALE, flash_min_kv=256)
    assert len(flash_calls) == 1
    # A CPU tensor takes the plain version: no kernel launch.
    assert all(c == 0 for c in cuda_lib.launch_counts.values())
    assert out.dtype == tv.dtype and tuple(out.shape) == (2, 3, n_q, 64)
    got = out.float().numpy()
    dense, ref = _jit_in_f32(dtype, lambda a, b, c: (
        jattn.sdpa(a, b, c, SCALE, flash_min_kv=256),
        _padded_reference(n_q, n_k)(a, b, c)))(jq, jk, jv)
    assert _rel_err(got, dense) <= TOL_JAX[dtype]
    assert _rel_err(got, ref) <= TOL_REF[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_q,n_k", SHAPES)
def test_sdpa_flash_branch_gradients_match_jax(flash_calls, n_q, n_k, dtype):
    q, k, v, do = _inputs(n_q, n_k, seed=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = attention.sdpa(tq, tk, tv, SCALE, flash_min_kv=256)
    assert len(flash_calls) == 1
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    dense = lambda a, b, c: jattn.sdpa(a, b, c, SCALE, flash_min_kv=256)  # noqa: E731
    # mha_reference's own VJP takes sm_scale = 1 only: scale q instead.
    ref = _padded_reference(n_q, n_k, SCALE, 1.0)
    vjps = _jit_in_f32(dtype, lambda a, b, c, d: (
        jax.vjp(dense, a, b, c)[1](d), jax.vjp(ref, a, b, c)[1](d)))
    for name, g, gj, gr in zip("qkv", grads, *vjps(jq, jk, jv, jdo)):
        assert g.dtype == tdt
        assert _rel_err(g.float().numpy(), gj) <= TOL_JAX[dtype], name
        assert _rel_err(g.float().numpy(), gr) <= TOL_REF[dtype], name


@pytest.mark.parametrize("n_q,n_k", SHAPES)
def test_flash_plain_versions_match_jax(n_q, n_k):
    """The plain versions that `chip_smoke.py` holds K5's kernels against
    (forward with its log-sum-exp, dK/dV, dQ from lse and di), in float32,
    against JAX's dense `sdpa` and its VJP."""
    q, k, v, do = _inputs(n_q, n_k, seed=2)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = attention.flash_forward_plain(tq, tk, tv, SCALE)

    def jax_ref(a, b, c, d):
        out, vjp = jax.vjp(lambda *x: jattn.sdpa(*x, SCALE), a, b, c)
        return out, vjp(d)

    jo, jgrads = jax.jit(jax_ref)(*map(jnp.asarray, (q, k, v, do)))
    assert _rel_err(o.numpy(), jo) <= 1e-5
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) * SCALE
    np.testing.assert_allclose(
        lse.numpy(), jax.scipy.special.logsumexp(logits, axis=-1), rtol=1e-5)
    di = (tdo * o).sum(-1)
    dk, dv = attention.flash_backward_dkv_plain(tq, tk, tv, tdo, lse, di, SCALE)
    dq = attention.flash_backward_dq_plain(tq, tk, tv, tdo, lse, di, SCALE)
    for name, g, gj in zip("qkv", (dq, dk, dv), jgrads):
        assert _rel_err(g.numpy(), gj) <= 1e-5, name


def test_sdpa_below_threshold_stays_dense(flash_calls, monkeypatch):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(40, 40))
    attention.sdpa(q, k, v, SCALE)
    monkeypatch.setattr(attention, "FLASH_MIN_KV", 40)
    attention.sdpa(q, k, v, SCALE)   # the threshold is read at call time
    assert len(flash_calls) == 1


@pytest.mark.parametrize("num_target,chunk_q", [(1, 8), (2, 20)])
def test_view_masked_chunked_matches_jax(num_target, chunk_q):
    """The query-chunked branch (chunked_min_kv lowered to 32) against
    JAX's, and against the port's own dense branch; with gradients."""
    rng = np.random.default_rng(3)
    views, l, nq_views = 3, 20, 2
    q = rng.standard_normal((2, 3, nq_views * l, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, views * l, 64)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    jmask = jbuild_mask(views, num_target)[1:]
    mask = torch.from_numpy(np.array(jmask))
    kw = dict(chunk_q=chunk_q, chunked_min_kv=32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention.sdpa_view_masked(tq, tk, tv, SCALE, mask, l, **kw)

    def jax_ref(a, b, c, d):
        jout, vjp = jax.vjp(lambda *x: jattn.sdpa_view_masked(
            *x, SCALE, jmask, l, **kw), a, b, c)
        return jout, vjp(d)

    jout, jgrads = jax.jit(jax_ref)(*map(jnp.asarray, (q, k, v, do)))
    assert _rel_err(out.detach().numpy(), jout) <= 1e-5
    dense = attention.sdpa_view_masked(tq, tk, tv, SCALE, mask, l)
    torch.testing.assert_close(out, dense, rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, g, gj in zip("qkv", grads, jgrads):
        assert _rel_err(g.numpy(), gj) <= 1e-5, name


def test_evaluate_example_flash_branch_matches_jax(flash_calls, monkeypatch,
                                                   tmp_path):
    """The tiny encoder (float32) through `evaluate_example` with every
    self-attention on the flash branch (the port's threshold lowered to 1
    key) and the quantized depth key, against JAX at the same weights."""
    example = make_example()
    c, t = example["context"], example["target"]
    jenc = jax_tiny_encoder()
    params = random_flax_params(jenc, 2, c["image"][None], c["intrinsics"][None],
                                t["image"][None], t["intrinsics"][None])
    # The long-context path's rasterizer, at the slice test's chunk.
    raster = dataclasses.replace(LONG_CONTEXT_DECODER.rasterizer, chunk=64)
    jres = jeval.evaluate_example(
        jenc, params, example, HW,
        JDecoderConfig(rasterizer=JRasterizerConfig(
            backend="pallas", entry_budget_factor=raster.entry_budget_factor,
            chunk=raster.chunk, depth_key=raster.depth_key)),
        jeval.EvalConfig(per_target_encoding=True, save_images=True,
                         output_path=str(tmp_path)))
    monkeypatch.setattr(attention, "FLASH_MIN_KV", 1)
    cuda_lib.reset_launch_counts()
    tres = evaluator.evaluate_example(
        torch_tiny_encoder(params), example, HW,
        dataclasses.replace(LONG_CONTEXT_DECODER, rasterizer=raster),
        evaluator.EvalConfig(per_target_encoding=True), device="cpu")
    # One encoder pass: 2 encoder blocks + 2 x 2 decoder blocks, each with
    # one self-attention.
    assert len(flash_calls) == 6
    assert all(c == 0 for c in cuda_lib.launch_counts.values())
    assert tres["dropped_entries"] == [0]
    rendered = torch.clamp(tres["rendered"], 0, 1).numpy()
    # 1e-4, not the slice test's 3e-5: quantized depth keys tie, and JAX's
    # unstable sort orders ties otherwise than the port's stable one
    # (ROADMAP.md section 3); the largest pixel gap here is 4.5e-5.
    assert_images_close(rendered, jres["images"], atol=1e-4)
    np.testing.assert_allclose(tres["psnr"], jres["psnr"], atol=1e-3)
    np.testing.assert_allclose(tres["ssim"], jres["ssim"], atol=1e-4)
    for key in ("pose_rot_err_deg", "pose_transl_err_deg"):
        np.testing.assert_allclose(tres[key], jres[key], atol=1e-3, err_msg=key)
    assert float(np.mean(rendered)) > 0.0
