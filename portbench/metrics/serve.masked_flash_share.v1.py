"""`serve.masked_flash_share` in SPFSplat v1's serving cell: the view-
masked kernel's launches in a traced request's device trace over v1's
4 x dec_depth cross-attention calls with `FLASH_MIN_KV` keys or more (two
decoder passes; `portbench/view_masked.py`), in %.  Nothing is read where
the request has no such call or the trace holds no launch of the
kernel."""

from portbench import view_masked


def read(r):
    return view_masked.share(r, view_masked.v1_calls(r.config, r.traffic))
