"""The view-masked kernel's share of its roofline, in %: 4 b h pairs d
operations of each of a request's view-masked cross-attention calls, over
the query-key pairs that the model's cross-view mask leaves visible
(`portbench/view_masked.py`, the flagship's or SPFSplat v1's calls by the
configuration's family), at the bf16 tensor-core rate, over the kernel's
device time by name.  Nothing is read where the kernel is not launched,
or where its launches do not match those calls."""

from portbench import roofline, view_masked


def read(r):
    if r.kind != "serve" or r.trace is None:
        return None
    shapes = view_masked.request_shapes(r.config, r.traffic)
    seconds, n = r.trace.time_by_name(view_masked.KERNEL)
    if not shapes or seconds <= 0 or n != len(shapes) * r.trace.items:
        return None
    least = (r.trace.items * view_masked.flops(shapes)
             / roofline.PEAK_BF16)
    return 100.0 * least / seconds
