"""K2's share of its roofline, in %: the least time of its launches in the
traced segment (each Gaussian's row, K1's output and its cotangent read
once, a gradient row a Gaussian written once, at the HBM rate;
`portbench/roofline.py`) over K2's device time by name."""

from portbench import roofline


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    seconds, n = r.trace.time_by_name(roofline.KERNELS["k2"])
    if not n or seconds <= 0:
        return None
    tr = r.traffic
    g = len(tr["context_offsets"]) * tr["image_size"] ** 2
    least = n * roofline.k2_bytes(g, tr["image_size"]) / roofline.PEAK_BYTES
    return 100.0 * least / seconds
