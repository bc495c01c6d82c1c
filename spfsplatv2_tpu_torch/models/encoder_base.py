"""The skeleton that the port's encoders share.

An encoder maps unposed context (+ target) views to pixel-aligned
Gaussians and camera poses in two steps:

- `_network(*views)`, the encoder's own backbone and heads: `forward`'s
  context images, intrinsics, target images, intrinsics and the two view
  masks in; `(pts3d (b, v_cxt, h, w, 3), the raw Gaussian channels
  (b, v_cxt, h, w, c), every view's c2w pose (b, v, 4, 4) or None, *extra
  tensors)` out.  `_views` gathers its inputs and `_normalize_poses` its
  poses;
- `_assemble`, the Gaussians and the output dict, eagerly under the span
  `encoder.gaussians`.  An encoder whose network returns extra tensors,
  or that adds keys, extends the dict that `_assemble` returns.

`Encoder` runs `_network` eagerly.  `GraphedEncoder` replays it from a
CUDA graph in inference on the card (`utils/cuda_graph.py:EncoderGraphs`);
an encoder lists it among its bases to take the graphs.  `init_weights`
draws every Linear and convolution from the seeded generator in module
order, then `_init_own` draws the encoder's own tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from spfsplatv2_tpu_torch.geometry import se3
from spfsplatv2_tpu_torch.models.adapter import (
    map_pdf_to_opacity,
    unified_gaussian_adapter,
)
from spfsplatv2_tpu_torch.models.vggt.layers import LayerScale
from spfsplatv2_tpu_torch.utils.cuda_graph import EncoderGraphs
from spfsplatv2_tpu_torch.utils.init import lecun_normal_
from spfsplatv2_tpu_torch.utils.profiling import span


class Encoder(nn.Module):
    def forward(
        self,
        context_images: torch.Tensor,      # (b, v_cxt, h, w, 3) in [0, 1]
        context_intrinsics: torch.Tensor,  # (b, v_cxt, 3, 3) normalized
        target_images: torch.Tensor | None = None,
        target_intrinsics: torch.Tensor | None = None,
        global_step: int = 0,
        context_valid: torch.Tensor | None = None,  # (v_cxt,)
        target_valid: torch.Tensor | None = None,   # (v_tgt,)
    ) -> dict:
        """`context_valid` / `target_valid` drop views with static shapes:
        a dropped view vanishes from the attention across views, and its
        Gaussians get zero opacity."""
        net = self._run_network((context_images, context_intrinsics,
                                 target_images, target_intrinsics,
                                 context_valid, target_valid))
        v_tgt = 0 if target_images is None else target_images.shape[1]
        with span("encoder.gaussians"):
            return self._assemble(*net, global_step=global_step,
                                  v_all=context_images.shape[1] + v_tgt,
                                  context_valid=context_valid)

    def _run_network(self, views: tuple) -> tuple:
        return self._network(*views)

    @staticmethod
    def _views(context_images, context_intrinsics, target_images,
               target_intrinsics, context_valid, target_valid):
        """-> (every view's images and intrinsics, context first; the
        number of target views; each view's float32 validity (v,), or None
        where neither mask is given)."""
        v_cxt = context_images.shape[1]
        v_tgt = 0 if target_images is None else target_images.shape[1]
        images, intrinsics = context_images, context_intrinsics
        if v_tgt:
            images = torch.cat([context_images, target_images], dim=1)
            intrinsics = torch.cat([context_intrinsics, target_intrinsics],
                                   dim=1)
        view_valid = None
        if context_valid is not None or target_valid is not None:
            dev = context_images.device
            cv = (torch.ones((v_cxt,), device=dev) if context_valid is None
                  else context_valid.to(torch.float32))
            tv = (torch.ones((v_tgt,), device=dev) if target_valid is None
                  else target_valid.to(torch.float32))
            view_valid = torch.cat([cv, tv]) if v_tgt else cv
        return images, intrinsics, v_tgt, view_valid

    def _normalize_poses(self, poses: torch.Tensor, v_cxt: int) -> torch.Tensor:
        """c2w poses (b, v, 4, 4) -> rescaled to a unit baseline between
        views 0 and v_cxt - 1 (`pose_make_baseline_1`), then relative to
        view 0 (`pose_make_relative`)."""
        if self.cfg.pose_make_baseline_1:
            a = poses[:, 0, :3, 3]
            c = poses[:, v_cxt - 1, :3, 3]
            scale = torch.linalg.norm(a - c, dim=-1)[:, None, None]
            t = poses[:, :, :3, 3:] / torch.clamp(scale, min=1e-8)[..., None]
            poses = torch.cat([torch.cat([poses[:, :, :3, :3], t], dim=-1),
                               poses[:, :, 3:]], dim=-2)
        if self.cfg.pose_make_relative:
            poses = se3.camera_normalization(poses[:, 0:1], poses)
        return poses

    def _assemble(self, pts3d, raw_gs, extrinsics_cwt, extrinsics_c=None, *,
                  global_step: int, v_all: int, context_valid=None) -> dict:
        """The output dict: Gaussians from the context views' points and
        raw head channels (opacities zeroed for dropped context views),
        and depths from the context poses: `extrinsics_c` where the
        network made them apart, else the first v_cxt of
        `extrinsics_cwt`.  `v_all` counts the context and target views."""
        cfg = self.cfg
        b, v_cxt, h, w, _ = pts3d.shape
        if extrinsics_c is None and extrinsics_cwt is not None:
            extrinsics_c = extrinsics_cwt[:, :v_cxt]
        densities = torch.sigmoid(raw_gs[..., 0])
        om = cfg.opacity_mapping
        opacities = map_pdf_to_opacity(densities, global_step, om.initial,
                                       om.final, om.warm_up)
        if context_valid is not None:
            opacities = opacities * context_valid.to(opacities.dtype)[
                None, :, None, None
            ]
        gaussians = unified_gaussian_adapter(
            pts3d.reshape(b, v_cxt, h * w, 3),
            opacities.reshape(b, v_cxt, h * w),
            raw_gs[..., 1:].reshape(b, v_cxt, h * w, raw_gs.shape[-1] - 1),
            sh_degree=cfg.sh_degree,
        ).flatten_views()
        depths = None
        if extrinsics_c is not None:
            depths = se3.depth_from_pose(
                pts3d.reshape(b, v_cxt, h * w, 3), extrinsics_c
            ).reshape(b, v_cxt, h, w)
        return {
            "gaussians": gaussians,
            "extrinsics_c": extrinsics_c,
            "extrinsics_cwt": extrinsics_cwt,
            "pts3d": pts3d,
            "depths": depths,
            "densities": densities,
        }

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Encoder":
        """Seeded init following the flax module's initializers."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                lecun_normal_(mod.weight, generator,
                              transposed=isinstance(mod, nn.ConvTranspose2d))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm) and mod.elementwise_affine:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, LayerScale):
                mod.gamma.fill_(mod.init_value)
        self._init_own(generator)
        return self


class GraphedEncoder(Encoder):
    """An encoder whose `_network` replays `EncoderGraphs` in inference on
    the card (CUDA inputs, autograd off, `eval()`), one graph an input
    signature, and runs eagerly otherwise."""

    def _run_network(self, views: tuple) -> tuple:
        if (views[0].is_cuda and not torch.is_grad_enabled()
                and not self.training):
            return self._graphs()(self._network, views)
        return self._network(*views)

    def _graphs(self) -> EncoderGraphs:
        """The captured inference forwards, one a signature (made at first
        use; `train()` and moving or casting the module drop them)."""
        if getattr(self, "_graph_cache", None) is None:
            self._graph_cache = EncoderGraphs()
        return self._graph_cache

    def train(self, mode: bool = True):
        """As `nn.Module.train`; entering training drops the graphs."""
        if mode:
            self._graph_cache = None
        return super().train(mode)

    def _apply(self, fn, recurse=True):
        # The graphs read the parameters where they were at capture.
        self._graph_cache = None
        return super()._apply(fn, recurse)
