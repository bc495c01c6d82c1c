"""The float32 logits that the view-masked cross-attention forms in a
traced request, at 4 bytes each, in GiB: those its dense or query-chunked
branch writes out (`ops/cuda_lib.py:launch_counts`, "masked_attn_logits",
counted by `ops/attention.py:sdpa_view_masked`), and those the view-masked
kernel that took that branch's place forms on chip, over the query-key
pairs that each call's cross-view mask leaves visible
(`portbench/view_masked.py`), where its launches ("flash_view_masked")
match the request's calls.  Nothing is read where no count moved: a
forward replayed from a CUDA graph, or a program without the counts."""

from portbench import view_masked


def read(r):
    if r.kind != "serve":
        return None
    logits = r.launches.get("masked_attn_logits", 0)
    launched = r.launches.get("flash_view_masked", 0)
    if launched:
        shapes = view_masked.request_shapes(r.config, r.traffic)
        if launched != len(shapes):
            return None
        logits += sum(b * h * pairs for b, h, pairs, _ in shapes)
    if logits <= 0:
        return None
    return logits * 4 / 2**30
