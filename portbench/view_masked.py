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
view)."""

from __future__ import annotations

from portbench import roofline

KERNEL = "view_masked_fwd_kernel"


def _calls(bb: dict, tokens: int, passes) -> int:
    """2 dec_depth calls for each decoder pass over `views` views whose
    keys take the kernel."""
    if (bb.get("compute_dtype", "bfloat16") != "bfloat16"
            or bb["dec_embed_dim"] // bb["dec_num_heads"] != 64):
        return 0
    return sum(2 * bb["dec_depth"] for views in passes
               if views * tokens >= roofline.FLASH_MIN_KV)


def flagship_calls(config: dict, traffic: dict) -> int:
    """The flagship's kernel calls a request: one pass over all views."""
    bb = config["encoder"]["backbone"]
    views = len(traffic["context_offsets"]) + len(traffic["target_offsets"])
    p = (traffic["image_size"] // bb["patch_size"]) ** 2
    extra = int(bb["intrinsics_token"]) + int(bb["pose_token"])
    return _calls(bb, p + extra, [views])


def v1_calls(config: dict, traffic: dict) -> int:
    """SPFSplat v1's kernel calls a request: the context pass, then the
    all-views pass where the request has targets."""
    bb = config["encoder"]["backbone"]
    v_cxt = len(traffic["context_offsets"])
    v_all = v_cxt + len(traffic["target_offsets"])
    p = (traffic["image_size"] // bb["patch_size"]) ** 2
    passes = [v_cxt] + ([v_all] if v_all > v_cxt else [])
    return _calls(bb, p + int(bb["intrinsics_token"]), passes)


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
