"""The 3xTF32 arithmetic of K5's float32 kernels, on the CPU.

The kernels (`csrc/flash_f32_forward.cu`,
`csrc/flash_f32_backward_{dkv,dq}.cu`) run every product on the tensor
cores with tf32 operands: each float32 operand x is split into hi =
tf32(x) and lo = tf32(x - hi) (`cvt.rna.tf32.f32`), and a product is
lo*hi + hi*lo + hi*hi summed in float32.  Here `attention.tf32_round`
emulates the rounding with integer bit operations, and the forward and
the backward pair are computed with every product split that way, to
show where there is no GPU that the scheme meets the bars the card holds
the kernels to, and that one pass (hi*hi) does not.  The split
pre-passes' plain versions (`flash_f32_split_plain`,
`flash_f32_split_forward_plain`) are checked for their layout.
"""

import numpy as np
import pytest
import torch

from spfsplatv2_tpu_torch.ops.attention import (
    TF32_K_ORDER,
    flash_f32_split_forward_plain,
    flash_f32_split_plain,
    flash_forward_plain,
    tf32_round,
)

# The kernels' bars against the plain versions, as fractions of max |ref|
# (chip_smoke.py K5_TOLS["float32"], tests/test_torch_kernels.py).
OUT_TOL, GRAD_TOL = 2e-5, 1e-4


def test_tf32_round_is_cvt_rna():
    """Round to nearest with 10 mantissa bits, ties away from zero; the
    low 13 bits cleared; hi + lo represents x within 2^-22 of |x|."""
    ulp = 2.0**-10  # in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0**-23,
                      1 + 1.5 * ulp, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32) * 100)
    hi = tf32_round(y)
    lo = tf32_round(y - hi)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi - y).abs() / y.abs()).max()) <= 2.0**-11
    err = ((hi.double() + lo.double()) - y.double()).abs() / y.double().abs()
    assert float(err.max()) <= 2.0**-22


def _mm(a, b, passes):
    """a @ b over float32 with each operand split: three passes (lo*hi,
    hi*lo, hi*hi, in that order) or one (hi*hi)."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _backward(q, k, v, do, lse, di, scale, passes):
    """The backward pair's arithmetic, every product split."""
    kt, vt = k.transpose(-1, -2), v.transpose(-1, -2)
    p = torch.exp(_mm(q, kt, passes) * scale - lse[..., None])
    ds = p * (_mm(do, vt, passes) - di[..., None])
    dv = _mm(p.transpose(-1, -2), do, passes)
    dk = _mm(ds.transpose(-1, -2), q, passes) * scale
    dq = _mm(ds, k, passes) * scale
    return {"dq": dq, "dk": dk, "dv": dv}


def _inputs(shape, seed):
    b, h, n_q, n_k = shape
    rng = np.random.default_rng(seed)
    make = lambda n: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, h, n, 64)).astype(np.float32))
    return make(n_q), make(n_k), make(n_k), make(n_q)


@pytest.mark.parametrize("shape", [(1, 2, 256, 256), (1, 2, 200, 333)],
                         ids=["256", "ragged"])
def test_split_forward_meets_the_kernels_bars(shape):
    """The forward kernel's arithmetic at the backward test's seeded
    shapes: S = Q K^T split, the softmax in float32, P and V split for
    O = P V, O / l and lse = m + log l.  Three passes land within 2e-5 of
    max of the float64 softmax attention for O and lse; one pass errs at
    least 10x more."""
    q, k, v, _ = _inputs(shape, 7)
    scale = 0.125
    q64, k64, v64 = (t.double() for t in (q, k, v))
    s64 = q64 @ k64.transpose(-1, -2) * scale
    ref = {"o": torch.softmax(s64, dim=-1) @ v64,
           "lse": torch.logsumexp(s64, dim=-1)}

    errs = {}
    for passes in (3, 1):
        s = _mm(q, k.transpose(-1, -2), passes) * scale
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        got = {"o": _mm(p, v, passes) / l, "lse": (m + torch.log(l))[..., 0]}
        errs[passes] = {name: float((got[name].double() - ref[name]).abs()
                                    .max() / ref[name].abs().max())
                        for name in ref}
    for name in ref:
        assert errs[3][name] <= OUT_TOL, (name, errs)
        assert errs[1][name] >= 10 * errs[3][name], (name, errs)


@pytest.mark.parametrize("shape", [(1, 2, 256, 256), (1, 2, 200, 333)],
                         ids=["256", "ragged"])
def test_split_backward_meets_the_kernels_bars(shape):
    """At (1, 2, 256, 64) from seeded N(0, 1) inputs (and a ragged
    n_q != n_k), with lse and di from the float32 forward as the kernels
    get them: three passes land within 1e-4 of max of the float64 plain
    backward for dQ, dK and dV; one pass errs at least 10x more."""
    q, k, v, do = _inputs(shape, 7)
    scale = 0.125
    o, lse = flash_forward_plain(q, k, v, scale)
    di = (do * o).sum(-1)

    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    p64 = torch.softmax(q64 @ k64.transpose(-1, -2) * scale, dim=-1)
    o64 = p64 @ v64
    ds64 = p64 * (do64 @ v64.transpose(-1, -2)
                  - (do64 * o64).sum(-1, keepdim=True))
    ref = {"dq": ds64 @ k64 * scale,
           "dk": ds64.transpose(-1, -2) @ q64 * scale,
           "dv": p64.transpose(-1, -2) @ do64}

    errs = {}
    for passes in (3, 1):
        got = _backward(q, k, v, do, lse, di, scale, passes)
        errs[passes] = {name: float((got[name].double() - ref[name]).abs()
                                    .max() / ref[name].abs().max())
                        for name in ref}
    for name in ref:
        assert errs[3][name] <= GRAD_TOL, (name, errs)
        assert errs[1][name] >= 10 * errs[3][name], (name, errs)


def test_split_plain_layout():
    """The plain pre-passes: hi + lo is x within 2^-22; the transposed
    planes hold x's rows in TF32_K_ORDER inside each group of 8, zeros
    past n; a product over that permuted axis, with A's columns taken in
    the same order (as an accumulator becomes an A fragment), is the plain
    product; and the forward's pass writes k's planes as the backward's
    does and v's transposed planes in the same layout."""
    rng = np.random.default_rng(3)
    n = 13
    x = torch.from_numpy(rng.standard_normal((1, 2, n, 64)).astype(
        np.float32))
    sp = flash_f32_split_plain(x, x, x, x)
    hl = sp["k_hl"]
    assert hl.shape == (2, 2, n, 64)
    assert float((hl.double().sum(0) - x.double()[0]).abs().max()) <= (
        2.0**-22 * float(x.abs().max()))
    t = sp["k_t"]
    assert t.shape == (2, 2, 64, 16)
    order = [8 * g + i for g in range(2) for i in TF32_K_ORDER]
    for pos, row in enumerate(order):
        col = t[:, :, :, pos]
        if row < n:
            assert torch.equal(col, hl[:, :, row, :])
        else:
            assert not bool(col.any())
    a = torch.from_numpy(rng.standard_normal((5, n)).astype(np.float64))
    a16 = torch.nn.functional.pad(a, (0, 16 - n))
    b_t = t[0, 0].double()                      # (64, 16), permuted k
    got = a16[:, order] @ b_t.T
    want = a @ hl[0, 0].double()
    assert torch.allclose(got, want, rtol=0, atol=1e-12)
    v = torch.from_numpy(rng.standard_normal((1, 2, n, 64)).astype(
        np.float32))
    fwd = flash_f32_split_forward_plain(x, v)
    assert sorted(fwd) == ["k_hl", "v_t"]
    assert torch.equal(fwd["k_hl"], hl)
    assert torch.equal(fwd["v_t"], flash_f32_split_plain(v, v, v, v)["k_t"])
