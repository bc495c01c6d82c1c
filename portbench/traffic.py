"""The one traffic generator: training batches and serving requests from a
traffic file's parameters and the run's seed.

Every view follows `evaluation/profile_request.py`'s synthetic pattern:
seeded pixels, centred normalized intrinsics (focal 1), poses shifted
along x by the file's offsets, near and far from the file; each scene's
pixels are uniform in [0, s], its brightness s drawn from the file's
range, so that the rows of a batch, and the requests of a pool, differ.  A
training mix is a pool of `pool` distinct batches made on the device,
cycled; a serving mix is a host-side pool of `pool` distinct requests
(2 context views + 1 target), each moved to the device when it is sent.
"""

from __future__ import annotations

import hashlib

import torch


def substream(seed: int, tag: str) -> int:
    """A seed for one use of the run's seed (weights, data, sampling)."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).hexdigest()
    return int(digest[:15], 16)


def _views(gen, b: int, offsets, hw: int, near: float, far: float,
           brightness, device) -> dict:
    v = len(offsets)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], device=device)
    c2w = torch.eye(4, device=device).repeat(b, v, 1, 1)
    c2w[..., 0, 3] = torch.tensor(offsets, device=device)
    lo, hi = brightness
    scale = lo + (hi - lo) * torch.rand(b, 1, 1, 1, 1, generator=gen,
                                        device=device)
    return {"image": scale * torch.rand(b, v, hw, hw, 3, generator=gen,
                                        device=device),
            "intrinsics": k.expand(b, v, 3, 3).clone(), "extrinsics": c2w,
            "near": torch.full((b, v), float(near), device=device),
            "far": torch.full((b, v), float(far), device=device)}


def batch(traffic: dict, seed: int, index: int, device) -> dict:
    """Training batch `index` of the pool: b scenes of context + target."""
    gen = torch.Generator(device=device).manual_seed(
        substream(seed, f"batch{index}"))
    hw, b = traffic["image_size"], traffic["batch"]
    near, far = traffic["near"], traffic["far"]
    lit = traffic["brightness"]
    return {"context": _views(gen, b, traffic["context_offsets"], hw, near,
                              far, lit, device),
            "target": _views(gen, b, traffic["target_offsets"], hw, near,
                             far, lit, device)}


def request(traffic: dict, seed: int, index: int, device) -> dict:
    """Serving request `index` of the pool, on the host: "context" and
    "target" dicts of (v, ...) CPU tensors.  `device` is where the pixels
    are drawn (the card's generator), not where they are kept."""
    one = batch({**traffic, "batch": 1}, seed, index, device)
    return {part: {k: t[0].cpu() for k, t in views.items()}
            for part, views in one.items()}


def pool(traffic: dict, seed: int, device) -> list[dict]:
    """The whole pool: batches on the device, requests on the host."""
    make = batch if traffic["kind"] == "train" else request
    return [make(traffic, seed, i, device) for i in range(traffic["pool"])]

