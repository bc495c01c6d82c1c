"""Scaled-dot-product attention (torch port of
`spfsplatv2_tpu/ops/attention.py`).

Short sequences take the dense form: einsum in the compute dtype, float32
logits and softmax, then a cast back (plain tensor ops in JAX too).  At
`FLASH_MIN_KV` keys or more, `sdpa` takes the flash attention of kernel
K5, the port of JAX's bundled TPU flash attention: on CUDA tensors
three hand-written kernels behind a `torch.autograd.Function`, picked by
the inputs' dtype (bf16: `csrc/flash_forward.cu`,
`csrc/flash_backward_dkv.cu`, `csrc/flash_backward_dq.cu`; float32:
`csrc/flash_f32_forward.cu`, `csrc/flash_f32_backward_dkv.cu`,
`csrc/flash_f32_backward_dq.cu`, all three on 3xTF32, each after a split
pre-pass in `csrc/flash_f32_split.cu`); on CPU tensors their plain
version, the dense form.  The view-masked attention stays dense below
`chunked_min_kv` keys and is computed in query chunks above it, as in
JAX (no kernel there).
"""

from __future__ import annotations

import torch

from spfsplatv2_tpu_torch.ops import cuda_lib

FLASH_MIN_KV = 4096
HEAD_DIM = 64  # the only head dim K5 takes (1024 / 16 and 768 / 12)
# K5's libraries (`csrc/<name>.cu`: forward, dK/dV, dQ) for each dtype it
# takes.  As in the TPU kernel, the products run in the inputs' dtype with
# float32 sums, and the outputs come back in that dtype.
FLASH_KERNELS = {
    torch.bfloat16: ("flash_forward", "flash_backward_dkv",
                     "flash_backward_dq"),
    torch.float32: ("flash_f32_forward", "flash_f32_backward_dkv",
                    "flash_f32_backward_dq"),
}


def _dense(q, k, v, scale):
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _require_cuda(tensors: dict) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, "
                             f"got {t.device}")


def _check_flash_inputs(tensors: dict, n_q: int, n_k: int) -> int:
    """Raise unless K5 takes these tensors: one dtype that a kernel takes
    (bf16 or float32), one device, (b, h, n, 64), contiguous and 16-byte
    aligned; returns batch x heads.  Whether they lie on the card is the
    wrappers' own check."""
    q = tensors["q"]
    if q.dtype not in FLASH_KERNELS:
        raise ValueError(f"flash attention takes bfloat16 or float32, got "
                         f"{q.dtype}")
    for name, t in tensors.items():
        if t.dtype != q.dtype or t.device != q.device or t.ndim != 4:
            raise ValueError(
                f"{name}: expected 4-d {q.dtype} on {q.device} as q, got "
                f"{t.ndim}-d {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    b, h, _, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash attention takes head dim {HEAD_DIM}, got {d}")
    for name, t in tensors.items():
        n = n_q if name in ("q", "do") else n_k
        if tuple(t.shape) != (b, h, n, d):
            raise ValueError(f"{name}: expected {(b, h, n, d)}, got "
                             f"{tuple(t.shape)}")
    if b * h > 65535:
        raise ValueError(f"flash attention takes at most 65535 batch x heads, "
                         f"got {b * h}")
    return b * h


def flash_limits_violation(device: torch.device, dtype: torch.dtype,
                           attentions) -> str | None:
    """What K5 would refuse among a model's self-attentions, or None.

    `attentions` lists each self-attention's (keys, head dim).  One with
    `FLASH_MIN_KV` keys or more (read at call time, as `sdpa` does) on a
    CUDA device takes K5, which takes bfloat16 or float32 with head dim 64
    only; on the CPU it is dense and takes anything."""
    if torch.device(device).type != "cuda":
        return None
    for keys, head_dim in attentions:
        if keys >= FLASH_MIN_KV and (dtype not in FLASH_KERNELS
                                     or head_dim != HEAD_DIM):
            return (f"a self-attention over {keys} keys takes the flash "
                    f"attention kernel K5 (at {FLASH_MIN_KV} keys or more "
                    f"on CUDA), which takes bfloat16 or float32 with head "
                    f"dim {HEAD_DIM} only; got {dtype} with head dim "
                    f"{head_dim}")
    return None


def _require_f32(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    cuda_lib.require(t, name, torch.float32, len(shape), device)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def flash_forward_plain(q, k, v, scale):
    """The plain version of K5's forward, in its arithmetic: float32 logits
    and softmax numerator, the numerator rounded to v's dtype for the PV
    product (nothing is rounded for float32), the sum taken in float32.
    Returns O in v's dtype and the rows' log-sum-exp, (b, h, n_q)
    float32.  (`flash_attention` on CPU tensors takes the dense form
    instead, which rounds the logits to the compute dtype, as JAX's dense
    branch does.)"""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return o.to(v.dtype), (m + torch.log(l))[..., 0]


def flash_forward_cuda(q, k, v, scale):
    """Launch K5's forward on contiguous (b, h, n, 64) bf16 or float32 CUDA
    tensors (the kernel of their dtype); returns O (b, h, n_q, 64) in that
    dtype and lse (b, h, n_q) float32."""
    n_q, n_k = q.shape[2], k.shape[2]
    tensors = {"q": q, "k": k, "v": v}
    _require_cuda(tensors)
    bh = _check_flash_inputs(tensors, n_q, n_k)
    scale = float(scale)
    # The kernels take a positive scale (their row max is over the raw
    # logits); any other is folded into q, exactly in either dtype.
    if scale < 0:
        q, scale = -q, -scale
    elif scale == 0:
        q, scale = torch.zeros_like(q), 1.0
    name = FLASH_KERNELS[q.dtype][0]
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:
        # The float32 kernel reads K and V as the forward split pre-pass's
        # planes (it splits q itself).
        sp = flash_f32_split_forward_cuda(k, v)
        k, v = sp["k_hl"], sp["v_t"]
    err = getattr(cuda_lib.library(name), f"spf_{name}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, n_q, n_k, scale, cuda_lib.stream_handle(q.device))
    cuda_lib.launch_counts[name] += 1
    cuda_lib.check(err, name)
    return o, lse


def _p_and_ds(q, k, v, do, lse, di, scale):
    """K5's backward arithmetic in float32: P rebuilt from lse and dS, both
    rounded to the inputs' dtype, as the kernels round them before their
    last products (a no-op for float32, whose kernels round nothing)."""
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
                  * scale - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - di[..., None])
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_backward_dkv_plain(q, k, v, do, lse, di, scale):
    """The plain version of K5's dK/dV kernel; returns (dk, dv)."""
    p, ds = _p_and_ds(q, k, v, do, lse, di, scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_dq_plain(q, k, v, do, lse, di, scale):
    """The plain version of K5's dQ kernel."""
    _, ds = _p_and_ds(q, k, v, do, lse, di, scale)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale).to(q.dtype)


def _check_backward_inputs(q, k, v, do, lse, di) -> int:
    tensors = {"q": q, "k": k, "v": v, "do": do}
    _require_cuda({**tensors, "lse": lse, "di": di})
    bh = _check_flash_inputs(tensors, q.shape[2], k.shape[2])
    _require_f32(lse, "lse", tuple(q.shape[:3]), q.device)
    _require_f32(di, "di", tuple(q.shape[:3]), q.device)
    return bh


# The split pre-passes of K5's float32 kernels (`csrc/flash_f32_split.cu`):
# their products run on the tensor cores as 3xTF32, with each operand
# split into hi = tf32(x) and lo = tf32(x - hi).  Transposed operands have
# their n axis permuted inside each group of 8: position L holds row
# TF32_K_ORDER[L], the order in which a tf32 accumulator's columns make up
# the next product's A fragment.  The backward's pass splits q, k, v and
# dO as they lie and q, k, dO transposed; the forward's k as it lies and v
# transposed (the forward kernel splits q in registers).
TF32_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
F32_SPLIT_AS_LAID = ("q", "k", "v", "do")
F32_SPLIT_TRANSPOSED = ("q", "k", "do")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32 as `cvt.rna.tf32.f32` does: to the nearest
    value with 10 mantissa bits, ties away from zero (half an ulp added to
    the magnitude's bits, the low 13 bits cleared); finite inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_hl(x: torch.Tensor) -> torch.Tensor:
    """(2, ...) hi = tf32(x), lo = tf32(x - hi) (x - hi is exact)."""
    hi = tf32_round(x)
    return torch.stack((hi, tf32_round(x - hi)))


def _transposed_order(n: int, device) -> torch.Tensor:
    """The rows of x that the n8 = 8 * ceil(n / 8) positions of a
    transposed plane hold, in TF32_K_ORDER inside each group of 8."""
    n8 = -(-n // 8) * 8
    order = torch.tensor(TF32_K_ORDER, device=device)
    return (torch.arange(0, n8, 8, device=device)[:, None] + order).reshape(-1)


def _split_planes(tensors: dict, as_laid, transposed) -> dict:
    out = {}
    for name, x in tensors.items():
        b, h, n, d = x.shape
        hl = _split_hl(x.reshape(b * h, n, d).float())
        if name in as_laid:
            out[f"{name}_hl"] = hl
        if name in transposed:
            order = _transposed_order(n, x.device)
            padded = torch.nn.functional.pad(hl, (0, 0, 0, len(order) - n))
            out[f"{name}_t"] = padded[:, :, order].transpose(2, 3).contiguous()
    return out


def flash_f32_split_plain(q, k, v, do) -> dict:
    """The plain version of the backward's split pre-pass on (b, h, n, 64)
    float32: `<name>_hl` (2, b*h, n, 64), the hi and lo planes of q, k, v
    and dO as they lie; `<name>_t` (2, b*h, 64, n8), those of q, k and dO
    transposed, padded with zero rows to n8 and permuted (TF32_K_ORDER).
    Bit for bit what the kernel writes."""
    return _split_planes({"q": q, "k": k, "v": v, "do": do},
                         F32_SPLIT_AS_LAID, F32_SPLIT_TRANSPOSED)


def flash_f32_split_forward_plain(k, v) -> dict:
    """The plain version of the forward's split pre-pass: `k_hl` and `v_t`,
    laid out as in `flash_f32_split_plain`.  Bit for bit what the kernel
    writes."""
    return _split_planes({"k": k, "v": v}, ("k",), ("v",))


def flash_f32_split_cuda(q, k, v, do) -> dict:
    """Launch the split pre-pass on contiguous (b, h, n, 64) float32 CUDA
    tensors; returns the planes of `flash_f32_split_plain`."""
    tensors = {"q": q, "k": k, "v": v, "do": do}
    _require_cuda(tensors)
    n_q, n_k = q.shape[2], k.shape[2]
    bh = _check_flash_inputs(tensors, n_q, n_k)
    if q.dtype != torch.float32:
        raise ValueError(f"the split pre-pass takes float32, got {q.dtype}")
    out = {f"{name}_hl": torch.empty((2, bh, x.shape[2], HEAD_DIM),
                                     dtype=torch.float32, device=q.device)
           for name, x in tensors.items()}
    for name in F32_SPLIT_TRANSPOSED:
        n8 = -(-tensors[name].shape[2] // 8) * 8
        out[f"{name}_t"] = torch.empty((2, bh, HEAD_DIM, n8),
                                       dtype=torch.float32, device=q.device)
    name = "flash_f32_split"
    err = cuda_lib.library(name).spf_flash_f32_split(
        *(t.data_ptr() for t in (q, k, v, do)),
        *(out[f"{n}_hl"].data_ptr() for n in F32_SPLIT_AS_LAID),
        *(out[f"{n}_t"].data_ptr() for n in F32_SPLIT_TRANSPOSED),
        bh, n_q, n_k, cuda_lib.stream_handle(q.device))
    cuda_lib.launch_counts[name] += 1
    cuda_lib.check(err, name)
    return out


def flash_f32_split_forward_cuda(k, v) -> dict:
    """Launch the forward's split pre-pass on contiguous (b, h, n_k, 64)
    float32 CUDA tensors; returns the planes of
    `flash_f32_split_forward_plain`."""
    _require_cuda({"k": k, "v": v})
    if k.ndim != 4:
        raise ValueError(f"k: expected (b, h, n, {HEAD_DIM}), got "
                         f"{tuple(k.shape)}")
    b, h, n_k, _ = k.shape
    for name, x in (("k", k), ("v", v)):
        _require_f32(x, name, (b, h, n_k, HEAD_DIM), k.device)
    bh = b * h
    n8 = -(-n_k // 8) * 8
    out = {"k_hl": torch.empty((2, bh, n_k, HEAD_DIM), dtype=torch.float32,
                               device=k.device),
           "v_t": torch.empty((2, bh, HEAD_DIM, n8), dtype=torch.float32,
                              device=k.device)}
    err = cuda_lib.library("flash_f32_split").spf_flash_f32_split_forward(
        k.data_ptr(), v.data_ptr(), out["k_hl"].data_ptr(),
        out["v_t"].data_ptr(), bh, n_k, cuda_lib.stream_handle(k.device))
    cuda_lib.launch_counts["flash_f32_split_forward"] += 1
    cuda_lib.check(err, "flash_f32_split_forward")
    return out


def _f32_split(q, k, v, do, split):
    """The split planes for the float32 backward kernels: `split` when the
    caller ran the pre-pass (the autograd function runs it once for both
    kernels), else a launch of it here."""
    if split is None:
        return flash_f32_split_cuda(q, k, v, do)
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        want = (2, x.shape[0] * x.shape[1], x.shape[2], HEAD_DIM)
        _require_f32(split[f"{name}_hl"], f"{name}_hl", want, x.device)
    for name, x in (("q", q), ("k", k), ("do", do)):
        want = (2, x.shape[0] * x.shape[1], HEAD_DIM, -(-x.shape[2] // 8) * 8)
        _require_f32(split[f"{name}_t"], f"{name}_t", want, x.device)
    return split


def flash_backward_dkv_cuda(q, k, v, do, lse, di, scale, split=None):
    """Launch K5's dK/dV kernel of the inputs' dtype; returns (dk, dv) in
    that dtype.  float32 reads the split pre-pass's planes: `split` from
    `flash_f32_split_cuda` on the same inputs, or None to run it here."""
    bh = _check_backward_inputs(q, k, v, do, lse, di)
    name = FLASH_KERNELS[q.dtype][1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.float32:
        sp = _f32_split(q, k, v, do, split)
        ins = [sp[n].data_ptr() for n in ("q_hl", "k_hl", "v_hl", "do_hl",
                                          "q_t", "do_t")]
    else:
        ins = [t.data_ptr() for t in (q, k, v, do)]
    err = getattr(cuda_lib.library(name), f"spf_{name}")(
        *ins, lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, q.shape[2], k.shape[2], float(scale),
        cuda_lib.stream_handle(q.device))
    cuda_lib.launch_counts[name] += 1
    cuda_lib.check(err, name)
    return dk, dv


def flash_backward_dq_cuda(q, k, v, do, lse, di, scale, split=None):
    """Launch K5's dQ kernel of the inputs' dtype; returns dq in that
    dtype.  `split` as for `flash_backward_dkv_cuda`."""
    bh = _check_backward_inputs(q, k, v, do, lse, di)
    name = FLASH_KERNELS[q.dtype][2]
    dq = torch.empty_like(q)
    if q.dtype == torch.float32:
        sp = _f32_split(q, k, v, do, split)
        ins = [sp[n].data_ptr() for n in ("q_hl", "k_hl", "v_hl", "do_hl",
                                          "k_t")]
    else:
        ins = [t.data_ptr() for t in (q, k, v, do)]
    err = getattr(cuda_lib.library(name), f"spf_{name}")(
        *ins, lse.data_ptr(), di.data_ptr(), dq.data_ptr(), bh, q.shape[2],
        k.shape[2], float(scale), cuda_lib.stream_handle(q.device))
    cuda_lib.launch_counts[name] += 1
    cuda_lib.check(err, name)
    return dq


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _FlashAttention(torch.autograd.Function):
    """K5 as a differentiable function: the forward kernel (for float32
    after its own split pre-pass) saves O and the rows' log-sum-exp; the
    backward computes di = rowsum(dO * O) in float32 (outside any kernel,
    as JAX does) and launches the dK/dV and dQ kernels (for float32 after
    one split pre-pass that both read)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        q, k, v = map(_aligned, (q, k, v))
        o, lse = flash_forward_cuda(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = _aligned(do.to(q.dtype))
        di = (do.float() * o.float()).sum(-1)
        split = (flash_f32_split_cuda(q, k, v, do)
                 if q.dtype == torch.float32 else None)
        dk, dv = flash_backward_dkv_cuda(q, k, v, do, lse, di, ctx.scale,
                                         split)
        dq = flash_backward_dq_cuda(q, k, v, do, lse, di, ctx.scale, split)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale):
    """Exact softmax attention over (b, h, n, d): K5 on CUDA tensors (bf16
    or float32, d = 64, or it raises), the dense form on CPU tensors."""
    if q.is_cuda:
        return _FlashAttention.apply(q, k, v, scale)
    return _dense(q, k, v, scale)


def sdpa(q, k, v, scale, *, flash_min_kv: int | None = None):
    """Unmasked attention over (b, h, n, d) tensors: flash attention at
    `flash_min_kv` keys or more, the dense form below.

    Unlike JAX's `sdpa`, whose default `flash_min_kv=FLASH_MIN_KV` is
    bound when the function is defined, the default here (None) reads
    the module's `FLASH_MIN_KV` at call time, on purpose: lowering that
    constant sends a whole model's self-attention down the flash branch,
    which the CPU slice test and the rehearsal of `chip_smoke.py` rely
    on (assigning JAX's constant changes nothing)."""
    if flash_min_kv is None:
        flash_min_kv = FLASH_MIN_KV
    if k.shape[2] >= flash_min_kv:
        return flash_attention(q, k, v, scale)
    return _dense(q, k, v, scale)


def sdpa_view_masked(q, k, v, scale, view_mask, tokens_per_view: int,
                     *, chunk_q: int = 512,
                     chunked_min_kv: int = FLASH_MIN_KV):
    """View-block-masked attention; view_mask (vq, vk) is additive (0/-inf)
    and token r belongs to view r // tokens_per_view.  At `chunked_min_kv`
    keys or more, when chunk_q divides n_q, queries go in chunks of
    `chunk_q` (logits O(chunk_q * n_k) at a time; exact, since softmax rows
    are independent)."""
    n_q, n_k = q.shape[2], k.shape[2]
    l = tokens_per_view
    if n_k < chunked_min_kv or n_q % chunk_q != 0:
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
        mask = view_mask.repeat_interleave(l, dim=0).repeat_interleave(l, dim=1)
        logits = logits + mask[None, None]
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v)

    kmask = view_mask.repeat_interleave(l, dim=1)              # (vq, n_k)
    rows = torch.arange(n_q, device=q.device) // l
    out = []
    for c0 in range(0, n_q, chunk_q):
        qi = q[:, :, c0:c0 + chunk_q]
        logits = torch.einsum("bhqd,bhkd->bhqk", qi, k).to(torch.float32)
        logits = logits * scale + kmask[rows[c0:c0 + chunk_q]][None, None]
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out.append(torch.einsum("bhqk,bhkd->bhqd", probs, v))
    return torch.cat(out, dim=2)
