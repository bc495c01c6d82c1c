"""Model FLOPs of a cell's step or request, counted by
`torch.utils.flop_counter.FlopCounterMode` over the plain reference on
meta tensors: the published model's work as the reference does it, not
what the program launches, so a change that removes or recomputes work
does not move it.

  * serving: the encoder's forward on one request, counted with autograd
    recording as in training (the same operations: FlopCounterMode's
    module tracker cannot hook a view of a parameter made without it,
    as VGGT-1B's camera head takes its empty pose tokens);
  * training: the encoder's forward and backward on one batch with no
    recompute (remat off), plus LPIPS's forward and its input gradient on
    the rendered targets.  The rasterizer is not counted.

    python3 portbench/flops.py <config name> <traffic name>

prints the count; the configuration file stores it under `model_flops`.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def no_remat(d):
    if isinstance(d, dict):
        return {k: (False if k in ("remat", "remat_heads") else no_remat(v))
                for k, v in d.items()}
    return d


def count(config: dict, traffic: dict) -> int:
    ref = config["reference"]
    enc_cfg = harness.build(harness.resolve(ref["config"]),
                            no_remat(harness.all_float32(config["encoder"])))
    hw = traffic["image_size"]
    train = traffic["kind"] == "train"
    b = traffic["batch"] if train else 1
    v_c, v_t = len(traffic["context_offsets"]), len(traffic["target_offsets"])
    meta = torch.device("meta")
    with meta:
        enc = harness.resolve(ref["encoder"])(enc_cfg)
        lp = harness.resolve(ref["lpips"])().requires_grad_(False)
    for mod in enc.modules():   # the reference's own recompute, too
        if hasattr(mod, "remat"):
            mod.remat = False
    k = torch.eye(3, device=meta)
    imgs = lambda v: torch.empty(b, v, hw, hw, 3, device=meta)
    intr = lambda v: k.expand(b, v, 3, 3)
    with FlopCounterMode(display=False) as counter:
        with torch.set_grad_enabled(True):
            out = enc(imgs(v_c), intr(v_c), imgs(v_t), intr(v_t))
        if train:
            g = out["gaussians"]
            surrogate = (g.means.sum() + g.covariances.sum()
                         + g.harmonics.sum() + g.opacities.sum()
                         + out["pts3d"].sum() + out["extrinsics_cwt"].sum())
            pred = torch.empty(b * v_t, hw, hw, 3, device=meta,
                               requires_grad=True)
            gt = torch.empty(b * v_t, hw, hw, 3, device=meta)
            surrogate = surrogate + lp(pred * 2 - 1, gt * 2 - 1).sum()
            surrogate.backward()
    return int(counter.get_total_flops())


def main(argv) -> None:
    conf, tr = argv
    config = json.loads((ROOT / "portbench" / "configs" / f"{conf}.json")
                        .read_text())
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{tr}.json")
                         .read_text())
    print(count(config, traffic))


if __name__ == "__main__":
    main(sys.argv[1:])
