"""Model FLOPs of the requests completed in the window over the window's
seconds and the card's bf16 peak, in %.  The FLOPs are the published
model's forward as the plain reference does it (`portbench/flops.py`),
stored with the configuration."""

from portbench import roofline


def read(r):
    if r.kind != "serve" or not r.flops_per_item or not r.items:
        return None
    return r.flops_per_item * r.items / r.window_s / roofline.PEAK_BF16 * 100
