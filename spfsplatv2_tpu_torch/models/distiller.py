"""DUSt3R teacher for pointmap distillation (torch port of
`spfsplatv2_tpu/models/distiller.py`).

A frozen pairwise DUSt3R predicts pointmaps and confidences for the two
context views during the first `distill_max_steps` training steps.  It
is the masked CroCo backbone at v = 2 with no extra tokens (each view
cross-attends to the other) and two DPT heads with a confidence
channel.  The teacher sits in no optimizer group and in no checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from spfsplatv2_tpu_torch.geometry.pointcloud import normalize_pointcloud
from spfsplatv2_tpu_torch.models.croco.backbone import (
    CrocoBackboneConfig,
    MaskedCrocoBackbone,
)
from spfsplatv2_tpu_torch.models.encoder import dpt_hooks
from spfsplatv2_tpu_torch.models.heads.dpt import DPTHead
from spfsplatv2_tpu_torch.models.heads.postprocess import pts3d_postprocess
from spfsplatv2_tpu_torch.utils.init import lecun_normal_


@dataclass(frozen=True)
class DistillerConfig:
    backbone: CrocoBackboneConfig = field(
        default_factory=lambda: CrocoBackboneConfig(
            intrinsics_token=False, pose_token=False
        )
    )


class Dust3RDistiller(nn.Module):
    def __init__(self, cfg: DistillerConfig = DistillerConfig()):
        super().__init__()
        self.cfg = cfg
        bb = cfg.backbone
        self.backbone = MaskedCrocoBackbone(bb)
        in_dims = (bb.enc_embed_dim,) + (bb.dec_embed_dim,) * 3
        self.downstream_head1 = DPTHead(in_dims, out_channels=4)
        self.downstream_head2 = DPTHead(in_dims, out_channels=4)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Dust3RDistiller":
        """Seeded init following the flax initializers (LeCun truncated
        normal kernels, zero biases, unit LayerNorms)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                lecun_normal_(mod.weight, generator,
                              transposed=isinstance(mod, nn.ConvTranspose2d))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        return self

    def forward(self, images: torch.Tensor, normalize: bool = True) -> dict:
        """images (b, 2, h, w, 3) in [0, 1] -> {"pts3d": (b, 2, h, w, 3) in
        view 0's frame, "conf": (b, 2, h, w)}."""
        b, v, h, w, _ = images.shape
        if v != 2:
            raise ValueError(f"the DUSt3R teacher is pairwise, got {v} views")
        out = self.backbone(images * 2.0 - 1.0, None, num_target=0)
        dec_feat, grid = out["dec_feat"], out["grid"]
        hooked = [dec_feat[i] for i in dpt_hooks(len(dec_feat) - 1)]
        pts, conf = [], []
        for view, head in enumerate((self.downstream_head1,
                                     self.downstream_head2)):
            raw = head([t[:, view] for t in hooked], grid)
            pts.append(pts3d_postprocess(raw[..., :3], "exp"))
            conf.append(1.0 + torch.exp(torch.clamp(raw[..., 3], max=10.0)))
        if normalize:
            pts[0], pts[1], _ = normalize_pointcloud(pts[0], pts[1], "avg_dis")
        return {"pts3d": torch.stack(pts, dim=1), "conf": torch.stack(conf, dim=1)}


def build_distiller(cfg: DistillerConfig = DistillerConfig(), seed: int = 0,
                    device: str | torch.device = "cuda") -> Dust3RDistiller:
    """The teacher on `device`, seeded, frozen (no gradients) and in
    eval mode."""
    device = torch.device(device)
    with device:
        model = Dust3RDistiller(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model.init_weights(gen).requires_grad_(False).eval()
