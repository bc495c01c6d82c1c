"""Model FLOPs of the training steps completed in the window over the
window's seconds and the card's bf16 peak, in %.  The FLOPs are the
reference's forward and backward (no recompute) and LPIPS's forward and
input gradient (`portbench/flops.py`), stored with the configuration."""

from portbench import roofline


def read(r):
    if r.kind != "train" or not r.flops_per_item or not r.items:
        return None
    return r.flops_per_item * r.items / r.window_s / roofline.PEAK_BF16 * 100
