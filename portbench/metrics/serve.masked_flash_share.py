"""The share of the flagship's view-masked cross-attention calls with
`FLASH_MIN_KV` keys or more that ran the view-masked kernel, in %: its
launches in a traced request's device trace (the encoder's CUDA graph
replays them, so no host counter sees them) over 2 x dec_depth
(`portbench/view_masked.py`).  Nothing is read where the request has no
such call or the trace holds no launch of the kernel."""

from portbench import view_masked


def read(r):
    return view_masked.share(r, view_masked.flagship_calls(r.config,
                                                           r.traffic))
