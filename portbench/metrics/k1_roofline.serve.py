"""K1's share of its roofline, in %: the least time of K1's launches in the
traced segment, one a target camera of each request (the larger of its
bytes, each distinct 40-byte Gaussian row that some tile's front-to-back
walk reaches read once, 4 bytes a tile entry walked and the output
written once, at the HBM rate, and of its operations, 25 a blended
pixel-entry pair at the FP32 rate; `portbench/raster_work.py`,
`roofline.raster_least_s`), over those launches' device time by name.
The walk is counted on each traced request's own Gaussians and predicted
target pose after the segment.  Nothing is read without K1 launches, or
where the segment's launches are not the cameras counted."""

from portbench import roofline


def read(r):
    if r.kind != "serve":
        return None
    return roofline.raster_share(r, "k1")
