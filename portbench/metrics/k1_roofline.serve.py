"""K1's share of its roofline, in %: the least time of its launches in the
traced segment (each Gaussian's 40-byte row read once and the output
written once, at the HBM rate; `portbench/roofline.py`) over K1's device
time by name."""

from portbench import roofline


def read(r):
    if r.kind != "serve" or r.trace is None:
        return None
    seconds, n = r.trace.time_by_name(roofline.KERNELS["k1"])
    if not n or seconds <= 0:
        return None
    tr = r.traffic
    g = len(tr["context_offsets"]) * tr["image_size"] ** 2
    least = n * roofline.k1_bytes(g, tr["image_size"]) / roofline.PEAK_BYTES
    return 100.0 * least / seconds
