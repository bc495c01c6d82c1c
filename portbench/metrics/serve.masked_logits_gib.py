"""The float32 logits that the view-masked cross-attention writes densely
in a traced request (`ops/cuda_lib.py:launch_counts`,
"masked_attn_logits", counted by `ops/attention.py:sdpa_view_masked`),
at 4 bytes each, in GiB.  Nothing is read where the count did not move:
a forward replayed from a CUDA graph, or a program without the count."""


def read(r):
    logits = r.launches.get("masked_attn_logits", 0)
    if r.kind != "serve" or logits <= 0:
        return None
    return logits * 4 / 2**30
