"""K5's forward launches of one SPFSplat v1 serving request (the
benchmark's own count, beside `roofline.py`'s for the flagship).

v1's unmasked backbone (`models/croco/backbone_multi.py`) appends one
intrinsics token to each view's patches at the encoder's input, so every
per-view self-attention has p + 1 keys: the encoder's blocks over all
views, then each decoder pass, over the context views and then over all
views, a layer at a time: its first decoder over view 0, its second over
the others.  Each has 4 b h n_q n_k d operations at the bf16 rate
(`roofline.k5_forward_flops`).
"""

from __future__ import annotations

from portbench import roofline


def k5_forward_shapes(config: dict, traffic: dict) -> list[tuple]:
    """(b, h, n_q, n_k, d) of each K5 forward launch of one request, in
    launch order: every self-attention with `roofline.FLASH_MIN_KV` keys
    or more."""
    bb = config["encoder"]["backbone"]
    v_cxt = len(traffic["context_offsets"])
    v_all = v_cxt + len(traffic["target_offsets"])
    n = ((traffic["image_size"] // bb["patch_size"]) ** 2
         + int(bb["intrinsics_token"]))
    h_enc, h_dec = bb["enc_num_heads"], bb["dec_num_heads"]
    d_enc = bb["enc_embed_dim"] // h_enc
    d_dec = bb["dec_embed_dim"] // h_dec
    shapes = [(v_all, h_enc, n, n, d_enc)] * bb["enc_depth"]
    for views in (v_cxt, v_all):
        shapes += [(1, h_dec, n, n, d_dec),
                   (views - 1, h_dec, n, n, d_dec)] * bb["dec_depth"]
    return [s for s in shapes if s[3] >= roofline.FLASH_MIN_KV]
