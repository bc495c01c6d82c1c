"""Vector drawing on images: anti-aliased points and lines, camera
frustums (torch port of `spfsplatv2_tpu/utils/drawing.py`).

The same signed-distance fields as the JAX package's numpy functions,
computed with torch on the device of the image (or of the cameras), as
the reference's drawing library does on the GPU.  `x_range` / `y_range`
map plot coordinates onto the image; colours are float RGB in [0, 1];
images are (h, w, 3) float tensors.
"""

from __future__ import annotations

import torch

__all__ = ["draw_points", "draw_lines", "draw_cameras"]


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _to_pixel_space(xy: torch.Tensor, shape, x_range, y_range) -> torch.Tensor:
    """Plot coordinates -> pixel coordinates."""
    h, w = shape
    if x_range is None:
        return xy
    x0, x1 = (float(v) for v in x_range)
    y0, y1 = (float(v) for v in y_range)
    px = (xy[..., 0] - x0) / max(x1 - x0, 1e-12) * w
    py = (xy[..., 1] - y0) / max(y1 - y0, 1e-12) * h
    return torch.stack([px, py], -1)


def _composite_sdf(image: torch.Tensor, alpha: torch.Tensor,
                   color: torch.Tensor) -> torch.Tensor:
    """alpha (n, h, w), color (n, 3) -> over-composited onto image."""
    out = image.to(torch.float32).clone()
    for a, c in zip(alpha, color):
        out = out * (1.0 - a[..., None]) + c * a[..., None]
    return out


def _pixel_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device) + 0.5,
        torch.arange(w, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")
    return xx, yy


def draw_points(image: torch.Tensor, points, color=(1.0, 1.0, 1.0),
                radius: float = 1.0, inner_radius: float = 0.0,
                x_range=None, y_range=None) -> torch.Tensor:
    """Anti-aliased discs (rings with `inner_radius`) at (n, 2) xy."""
    h, w, _ = image.shape
    points = _to_pixel_space(_as_tensor(points, image), (h, w), x_range,
                             y_range).reshape(-1, 2)
    color = _as_tensor(color, image).expand(len(points), 3)
    xx, yy = _pixel_grid(h, w, image.device)
    d = torch.hypot(xx[None] - points[:, 0, None, None],
                    yy[None] - points[:, 1, None, None])
    # A 1-pixel-wide edge.
    alpha = torch.clamp(radius + 0.5 - d, 0.0, 1.0)
    if inner_radius > 0:
        alpha = alpha * torch.clamp(d - inner_radius + 0.5, 0.0, 1.0)
    return _composite_sdf(image, alpha, color)


def draw_lines(image: torch.Tensor, start, end, color=(1.0, 1.0, 1.0),
               width: float = 1.0, x_range=None, y_range=None) -> torch.Tensor:
    """Anti-aliased segments from (n, 2) `start` to (n, 2) `end`, by
    point-to-segment distance fields."""
    h, w, _ = image.shape
    start = _to_pixel_space(_as_tensor(start, image), (h, w), x_range,
                            y_range).reshape(-1, 2)
    end = _to_pixel_space(_as_tensor(end, image), (h, w), x_range,
                          y_range).reshape(-1, 2)
    color = _as_tensor(color, image).expand(len(start), 3)
    xx, yy = _pixel_grid(h, w, image.device)
    p = torch.stack([xx, yy], -1)[None]          # (1, h, w, 2)
    a = start[:, None, None, :]                  # (n, 1, 1, 2)
    ab = end[:, None, None, :] - a
    denom = torch.clamp((ab * ab).sum(-1), min=1e-12)
    t = torch.clamp(((p - a) * ab).sum(-1) / denom, 0.0, 1.0)
    d = torch.linalg.norm(p - (a + t[..., None] * ab), dim=-1)
    alpha = torch.clamp(0.5 * width + 0.5 - d, 0.0, 1.0)
    return _composite_sdf(image, alpha, color)


def _unproject_frustum_corners(extrinsics: torch.Tensor,
                               intrinsics: torch.Tensor,
                               depth: float) -> torch.Tensor:
    """World positions (b, 4, 3) of the 4 image corners at `depth`."""
    corners = _as_tensor([[0, 0], [1, 0], [1, 1], [0, 1]], extrinsics)
    homo = torch.cat([corners, torch.ones_like(corners[:, :1])], -1)
    rays = torch.einsum("bij,cj->bci", torch.linalg.inv(intrinsics), homo)
    pts_cam = rays / rays[..., 2:3] * depth      # z = depth plane
    return (torch.einsum("bij,bcj->bci", extrinsics[:, :3, :3], pts_cam)
            + extrinsics[:, None, :3, 3])


def draw_cameras(resolution: int, extrinsics: torch.Tensor,
                 intrinsics: torch.Tensor, color, frustum_scale: float = 0.05,
                 margin: float = 0.1) -> torch.Tensor:
    """Camera frustum wireframes of (b, 4, 4) c2w `extrinsics` and (b, 3, 3)
    normalized `intrinsics`, projected onto the three axis-aligned planes:
    (3, resolution, resolution, 3) on the cameras' device."""
    extrinsics = extrinsics.to(torch.float32)
    intrinsics = intrinsics.to(torch.float32)
    b = extrinsics.shape[0]
    color = _as_tensor(color, extrinsics).expand(b, 3)
    origins = extrinsics[:, :3, 3]

    minima = origins.min(0).values
    maxima = origins.max(0).values
    span = max(float((maxima - minima).max()), 1e-3)
    # An equal-aspect box with a margin around the camera centres.
    center = 0.5 * (minima + maxima)
    half = span * (0.5 + margin)
    minima, maxima = center - half, center + half

    corners = _unproject_frustum_corners(extrinsics, intrinsics,
                                         span * frustum_scale)
    views = []
    for axis in range(3):
        ax = ((axis + 1) % 3, (axis + 2) % 3)
        c2 = corners[..., ax]                    # (b, 4, 2)
        o2 = origins[:, None, ax].expand(b, 4, 2)
        # Each camera: its 4 frustum edges, then origin -> corners.
        starts = torch.cat([c2, o2], 1).reshape(-1, 2)
        ends = torch.cat([torch.roll(c2, 1, dims=1), c2], 1).reshape(-1, 2)
        cols = color[:, None].expand(b, 8, 3).reshape(-1, 3)
        image = torch.zeros(resolution, resolution, 3,
                            device=extrinsics.device)
        views.append(draw_lines(
            image, starts, ends, cols, width=1.5,
            x_range=(minima[ax[0]], maxima[ax[0]]),
            y_range=(minima[ax[1]], maxima[ax[1]])))
    return torch.stack(views)
