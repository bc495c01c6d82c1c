"""K5's forward's share of its roofline in SPFSplat v1's request, in %:
4 b h n_q n_k d operations of each of its long self-attentions (encoder,
then both decoder passes; `portbench/roofline_v1.py`) at the bf16
tensor-core rate over the forward kernel's device time by name.  Nothing
is read where K5 is not launched, or where its launches do not match
those self-attentions."""

from portbench import roofline, roofline_v1


def read(r):
    if r.kind != "serve" or r.trace is None:
        return None
    seconds, n = r.trace.time_by_name(roofline.KERNELS["k5_fwd"])
    shapes = roofline_v1.k5_forward_shapes(r.config, r.traffic)
    if not n or seconds <= 0 or n != len(shapes) * r.trace.items:
        return None
    least = (r.trace.items * roofline.k5_forward_flops(shapes)
             / roofline.PEAK_BF16)
    return 100.0 * least / seconds
