"""K2's share of its roofline, in %: the least time of K2's launches in the
traced segment, one a rendered target of each step (the larger of its
bytes, each distinct row that some tile's front-to-back walk reaches read
once and its 40-byte gradient row written once, 4 bytes a tile entry
walked, K1's output and its cotangent read once, at the HBM rate, and of
its operations, 65 a blended pixel-entry pair at the FP32 rate;
`portbench/raster_work.py`, `roofline.raster_least_s`), over those
launches' device time by name.  The walk is counted on each traced
step's own Gaussians and predicted target poses, as its forward made
them, after the segment.  Nothing is read without K2 launches, or where
the segment's launches are not the cameras counted."""

from portbench import roofline


def read(r):
    if r.kind != "train":
        return None
    return roofline.raster_share(r, "k2")
