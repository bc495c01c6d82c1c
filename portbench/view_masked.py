"""The CroCo decoders' view-masked cross-attention calls that take the
port's view-masked kernel (`view_masked_fwd_kernel`), counted from the
shapes the benchmark hands in (the benchmark's own count, beside
`roofline.py`'s K5 shapes).

Each decoder layer runs two cross-attentions: its first decoder's (view
0's queries) and its second's (the other views'), both over every view's
tokens.  A call takes the kernel in the port's bf16 inference forward
when its keys, views x tokens a view, reach `roofline.FLASH_MIN_KV` and
its heads are 64 wide.  The flagship runs its decoders once over all
views (p patch tokens plus its intrinsics and pose tokens a view); SPFSplat
v1 twice, over the context views and then over all views (p + 1 tokens a
view).  Each call's least work, for the kernel's roofline, is 4 b h pairs
d over the query-key pairs that the model's cross-view mask leaves
visible."""

from __future__ import annotations

from portbench import roofline
from portbench.reference.models.croco.backbone import build_cross_view_mask

KERNEL = "view_masked_fwd_kernel"


def _pass_shapes(bb: dict, tokens: int, views: int,
                 num_target: int) -> list[tuple]:
    """(b, h, pairs, d) of each kernel call of one decoder pass over
    `views` views: dec_depth times its first decoder's (view 0's queries)
    and its second's (the others'), `pairs` the query-key pairs that the
    mask leaves visible (`build_cross_view_mask(views, num_target)`, as
    the model calls it), over `tokens` tokens a view.  Empty where the
    keys do not take the kernel."""
    h = bb["dec_num_heads"]
    d = bb["dec_embed_dim"] // h
    if (bb.get("compute_dtype", "bfloat16") != "bfloat16" or d != 64
            or views * tokens < roofline.FLASH_MIN_KV):
        return []
    seen = (build_cross_view_mask(views, num_target) == 0).sum(dim=1)
    first = (1, h, tokens * tokens * int(seen[0]), d)
    rest = (1, h, tokens * tokens * int(seen[1:].sum()), d)
    return [first, rest] * bb["dec_depth"]


def flagship_shapes(config: dict, traffic: dict) -> list[tuple]:
    """The flagship's kernel calls a request: one pass over all views, the
    trailing target views masked from the context views' queries."""
    bb = config["encoder"]["backbone"]
    v_tgt = len(traffic["target_offsets"])
    views = len(traffic["context_offsets"]) + v_tgt
    p = (traffic["image_size"] // bb["patch_size"]) ** 2
    extra = int(bb["intrinsics_token"]) + int(bb["pose_token"])
    return _pass_shapes(bb, p + extra, views, v_tgt)


def v1_shapes(config: dict, traffic: dict) -> list[tuple]:
    """SPFSplat v1's kernel calls a request: the context pass, then the
    all-views pass where the request has targets, neither with targets
    masked (`reference/models/croco/backbone_multi.py:_decode`)."""
    bb = config["encoder"]["backbone"]
    v_cxt = len(traffic["context_offsets"])
    v_all = v_cxt + len(traffic["target_offsets"])
    p = (traffic["image_size"] // bb["patch_size"]) ** 2
    passes = [v_cxt] + ([v_all] if v_all > v_cxt else [])
    return [s for views in passes
            for s in _pass_shapes(bb, p + int(bb["intrinsics_token"]),
                                  views, 0)]


SHAPES = {"spfsplatv2": flagship_shapes, "spfsplat": v1_shapes}


def request_shapes(config: dict, traffic: dict) -> list[tuple]:
    """The kernel's calls a request of the configuration's model; none
    for a model without the CroCo decoders."""
    shapes = SHAPES.get(config.get("family"))
    return shapes(config, traffic) if shapes else []


def flops(shapes) -> float:
    """4 b h pairs d: the least operations of the calls."""
    return sum(4.0 * b * h * pairs * d for b, h, pairs, d in shapes)


def flagship_calls(config: dict, traffic: dict) -> int:
    """The flagship's kernel calls a request: one pass over all views."""
    return len(flagship_shapes(config, traffic))


def v1_calls(config: dict, traffic: dict) -> int:
    """SPFSplat v1's kernel calls a request: the context pass, then the
    all-views pass where the request has targets."""
    return len(v1_shapes(config, traffic))


def share(r, calls: int) -> float | None:
    """The kernel's launches in the traced requests' device trace over
    `calls` a request, in %; nothing where there is no trace, no such
    call, or no launch of the kernel (a program without it)."""
    if r.kind != "serve" or r.trace is None or calls <= 0:
        return None
    _, n = r.trace.time_by_name(KERNEL)
    if not n:
        return None
    return 100.0 * n / (calls * r.trace.items)
