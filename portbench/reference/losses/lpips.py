"""LPIPS perceptual loss: VGG16 feature distance with learned linear
weights (torch port of `spfsplatv2_tpu/losses/lpips.py`).

Images in [-1, 1] are shifted and scaled by the LPIPS constants and run
through VGG16's convolutions; the activations after relu1_2, relu2_2,
relu3_3, relu4_3 and relu5_3 are unit-normalised over channels (eps
outside the sqrt, as the `lpips` package does), squared-differenced,
weighted by the ReLU of the per-channel "lin" weights, averaged over
space and summed over the five stages.

Public functions take (batch, h, w, 3) images, the JAX package's layout.
Weights come from a flax param tree through `utils/from_flax.py` (the
module and parameter names follow the flax ones), from `init_weights`,
a seeded init with the flax initializers' rules, or from an
`lpips.LPIPS(net="vgg")` state_dict file (`get_lpips`).  The canonical
LPIPS weights are not in the repository.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference.utils.init import lecun_normal_

# VGG16 conv plan: (channels, convs) per stage.
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# lpips.ScalingLayer constants (on [-1, 1] inputs).
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 through conv5_3; returns the five LPIPS stages (NCHW)."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        for s, (ch, n_conv) in enumerate(VGG_STAGES):
            for i in range(n_conv):
                setattr(self, f"conv{s + 1}_{i + 1}",
                        nn.Conv2d(in_ch, ch, 3, padding=1))
                in_ch = ch

    def forward(self, x):
        feats = []
        for s, (_, n_conv) in enumerate(VGG_STAGES):
            for i in range(n_conv):
                x = F.relu(getattr(self, f"conv{s + 1}_{i + 1}")(x))
            feats.append(x)
            if s < len(VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for s, (ch, _) in enumerate(VGG_STAGES):
            setattr(self, f"lin{s}", nn.Parameter(torch.zeros(ch)))
        self.register_buffer("shift", torch.tensor(LPIPS_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(LPIPS_SCALE), persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LPIPS":
        """The flax init: LeCun-normal kernels, zero biases, lin ~ U[0, 0.1)."""
        for mod in self.vgg.children():
            lecun_normal_(mod.weight, generator)
            mod.bias.zero_()
        for s in range(len(VGG_STAGES)):
            lin = getattr(self, f"lin{s}")
            lin.copy_(0.1 * torch.rand(lin.shape, generator=generator,
                                       device=lin.device))
        return self

    def forward(self, a, b):
        """a, b: (batch, h, w, 3) in [-1, 1] -> (batch,) distances."""

        def feats(x):
            x = (x - self.shift) / self.scale
            return self.vgg(x.permute(0, 3, 1, 2))

        total = 0.0
        for s, (xa, xb) in enumerate(zip(feats(a), feats(b))):
            na = xa / (torch.sqrt(torch.sum(xa**2, dim=1, keepdim=True)) + 1e-10)
            nb = xb / (torch.sqrt(torch.sum(xb**2, dim=1, keepdim=True)) + 1e-10)
            lin = F.relu(getattr(self, f"lin{s}"))
            contrib = torch.einsum("bchw,c->bhw", (na - nb) ** 2, lin)
            total = total + contrib.mean(dim=(1, 2))
        return total


def build_lpips(seed: int = 0, device: str | torch.device = "cuda") -> LPIPS:
    """A frozen LPIPS on `device`, initialised from a seeded generator."""
    device = torch.device(device)
    with device:
        model = LPIPS()
    gen = torch.Generator(device=device).manual_seed(seed)
    return model.init_weights(gen).eval().requires_grad_(False)


# torchvision VGG16 feature indices of the convolutions in each LPIPS slice.
_SLICE_CONVS = {1: (0, 2), 2: (5, 7), 3: (10, 12, 14), 4: (17, 19, 21),
                5: (24, 26, 28)}


def from_lpips_state_dict(torch_state: dict) -> dict[str, torch.Tensor]:
    """An `lpips.LPIPS(net="vgg")` state_dict -> this module's.

    Keys there: net.slice{1..5}.{idx}.weight/bias (OIHW, as here) and
    lin{0..4}.model.1.weight, a (1, C, 1, 1) convolution.
    """
    out = {}
    for s, idxs in _SLICE_CONVS.items():
        for i, idx in enumerate(idxs):
            for leaf in ("weight", "bias"):
                out[f"vgg.conv{s}_{i + 1}.{leaf}"] = torch_state[
                    f"net.slice{s}.{idx}.{leaf}"]
    for s in range(len(VGG_STAGES)):
        out[f"lin{s}"] = torch_state[f"lin{s}.model.1.weight"][0, :, 0, 0]
    return out


def get_lpips(use_lpips: bool, weights_path: str | None = None,
              device: str | torch.device = "cuda"):
    """-> (LPIPS module or None, calibrated).

    With `weights_path` (an `lpips.LPIPS(net="vgg")` state_dict file) the
    weights are those and `calibrated` is True; without it the VGG
    features are random ones from seed 0, fine as a training prior, and
    `calibrated` is False so that metric files label the score
    "lpips_uncalibrated".
    """
    if not use_lpips:
        return None, True
    if not weights_path:
        print("WARNING: no LPIPS weights path; using seeded random VGG "
              "features (set loss.lpips_weights_path for canonical LPIPS). "
              "Reported metrics will be labeled 'lpips_uncalibrated'.")
        return build_lpips(0, device), False
    state = torch.load(weights_path, map_location="cpu", weights_only=True)
    device = torch.device(device)
    with device:
        model = LPIPS()
    model.load_state_dict(from_lpips_state_dict(state), strict=True)
    return model.eval().requires_grad_(False), True


def lpips_distances(model: LPIPS, prediction, target) -> torch.Tensor:
    """(b, h, w, 3) images in [0, 1] -> (b,) LPIPS distances.

    Under autograd the VGG activations are recomputed in the backward pass
    (~3 GB at the flagship b=16 batch otherwise), as the JAX function's
    `jax.checkpoint` does.
    """
    a, b = prediction * 2 - 1, target * 2 - 1
    if torch.is_grad_enabled():
        return checkpoint(model, a, b, use_reentrant=False)
    return model(a, b)


def lpips_loss(model: LPIPS, prediction, target, weight: float = 1.0):
    """(b, h, w, 3) images in [0, 1] -> scalar weighted mean LPIPS."""
    return weight * torch.mean(lpips_distances(model, prediction, target))
