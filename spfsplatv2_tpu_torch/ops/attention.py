"""Scaled-dot-product attention, dense branches (torch port of
`spfsplatv2_tpu/ops/attention.py`).

The flagship's sequences (3 views x 258 tokens) take the dense form:
einsum in the compute dtype, float32 logits and softmax, then a cast back.
These are plain tensor ops in JAX too, not Pallas kernels.  Above the
thresholds the JAX package switches to a flash kernel (`sdpa`, a TPU
kernel still to be ported, K5) or to query chunking
(`sdpa_view_masked`); neither is on this port's path yet, so both raise.
"""

from __future__ import annotations

import torch

FLASH_MIN_KV = 4096


def _dense(q, k, v, scale):
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def sdpa(q, k, v, scale, *, flash_min_kv: int = FLASH_MIN_KV):
    """Unmasked attention over (b, h, n, d) tensors."""
    if k.shape[2] >= flash_min_kv:
        raise NotImplementedError(
            f"attention over {k.shape[2]} >= {flash_min_kv} keys takes the "
            "flash kernel (K5), which is not ported yet"
        )
    return _dense(q, k, v, scale)


def sdpa_view_masked(q, k, v, scale, view_mask, tokens_per_view: int,
                     *, chunk_q: int = 512,
                     chunked_min_kv: int = FLASH_MIN_KV):
    """View-block-masked attention; view_mask (vq, vk) is additive (0/-inf)
    and token r belongs to view r // tokens_per_view."""
    n_q, n_k = q.shape[2], k.shape[2]
    if not (n_k < chunked_min_kv or n_q % chunk_q != 0):
        raise NotImplementedError(
            f"query-chunked masked attention ({n_k} keys) is not ported yet"
        )
    l = tokens_per_view
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    mask = view_mask.repeat_interleave(l, dim=0).repeat_interleave(l, dim=1)
    logits = logits + mask[None, None]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
