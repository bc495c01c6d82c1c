"""Scaled-dot-product attention, plain: the dense form at every length.

A frozen copy of the port's `ops/attention.py` without its flash branch:
einsum in the inputs' dtype, float32 logits and softmax, then a cast back.
The view-masked attention is the port's, query-chunked above
`chunked_min_kv` keys (exact: softmax rows are independent).
"""

from __future__ import annotations

import torch

from portbench.reference.precision import fp8_grad, fp8_round

FLASH_MIN_KV = 4096


def _operands(fp8: bool, *ts):
    return tuple(fp8_round(t) for t in ts) if fp8 else ts


def _dense(q, k, v, scale, fp8: bool = False):
    q, k, v = _operands(fp8, q, k, v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    (probs,) = _operands(fp8, probs)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return fp8_grad(out) if fp8 else out


def flash_limits_violation(device, dtype, shapes):
    """The port refuses some dtypes at flash lengths; the dense form takes
    every one."""
    return None


def sdpa(q, k, v, scale, fp8: bool = False):
    """Unmasked attention over (b, h, n, d) tensors, dense; `fp8`: the
    control's float8 products (`precision.py`)."""
    return _dense(q, k, v, scale, fp8)


def sdpa_view_masked(q, k, v, scale, view_mask, tokens_per_view: int,
                     *, chunk_q: int = 512,
                     chunked_min_kv: int = FLASH_MIN_KV, fp8: bool = False):
    """View-block-masked attention; view_mask (vq, vk) is additive (0/-inf)
    and token r belongs to view r // tokens_per_view.  At `chunked_min_kv`
    keys or more, when chunk_q divides n_q, queries go in chunks of
    `chunk_q` (logits O(chunk_q * n_k) at a time; exact, since softmax rows
    are independent)."""
    q, k, v = _operands(fp8, q, k, v)
    n_q, n_k = q.shape[2], k.shape[2]
    l = tokens_per_view
    if n_k < chunked_min_kv or n_q % chunk_q != 0:
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
        mask = view_mask.repeat_interleave(l, dim=0).repeat_interleave(l, dim=1)
        logits = logits + mask[None, None]
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        (probs,) = _operands(fp8, probs)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return fp8_grad(out) if fp8 else out

    kmask = view_mask.repeat_interleave(l, dim=1)              # (vq, n_k)
    rows = torch.arange(n_q, device=q.device) // l
    out = []
    for c0 in range(0, n_q, chunk_q):
        qi = q[:, :, c0:c0 + chunk_q]
        logits = torch.einsum("bhqd,bhkd->bhqk", qi, k).to(torch.float32)
        logits = logits * scale + kmask[rows[c0:c0 + chunk_q]][None, None]
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        (probs,) = _operands(fp8, probs)
        out.append(torch.einsum("bhqk,bhkd->bhqd", probs, v))
    out = torch.cat(out, dim=2)
    return fp8_grad(out) if fp8 else out
