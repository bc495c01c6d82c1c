"""Encoder registry: name -> encoder variant (torch port of
`spfsplatv2_tpu/models/__init__.py`).

`EncoderSelectorConfig` is the config-side selector (the YAML/CLI
surface is `encoder.name=... encoder.<name>.<field>=...`) and
`get_encoder` builds the chosen variant: "spfsplat" (v1, the unmasked
CroCo backbone), the flagship "spfsplatv2" (masked CroCo backbone) or
"spfsplatv2l" (VGGT-1B).  `build_encoder` builds the encoder of a
variant's config.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from spfsplatv2_tpu_torch.models import encoder, encoder_spfsplat, encoder_vggt
from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config
from spfsplatv2_tpu_torch.models.encoder_spfsplat import SPFSplatConfig
from spfsplatv2_tpu_torch.models.encoder_vggt import SPFSplatV2LConfig

_ENCODERS = {SPFSplatConfig: encoder_spfsplat.SPFSplatEncoder,
             SPFSplatV2Config: encoder.SPFSplatV2Encoder,
             SPFSplatV2LConfig: encoder_vggt.SPFSplatV2LEncoder}
ENCODERS = ("spfsplat", "spfsplatv2", "spfsplatv2l")


@dataclass(frozen=True)
class EncoderSelectorConfig:
    name: str = "spfsplatv2"
    spfsplat: SPFSplatConfig = field(default_factory=SPFSplatConfig)
    spfsplatv2: SPFSplatV2Config = field(default_factory=SPFSplatV2Config)
    spfsplatv2l: SPFSplatV2LConfig = field(default_factory=SPFSplatV2LConfig)

    @property
    def variant_cfg(self):
        if self.name not in ENCODERS:
            raise KeyError(
                f"unknown encoder {self.name!r}; options: {sorted(ENCODERS)}"
            )
        return getattr(self, self.name)


def build_encoder(cfg, seed: int = 0, device: str | torch.device = "cuda"):
    """The encoder of a variant's config, constructed on `device`,
    initialised from a seeded `torch.Generator` on that device, in
    `eval()`."""
    device = torch.device(device)
    with device:
        model = _ENCODERS[type(cfg)](cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model.init_weights(gen).eval()


def get_encoder(cfg: EncoderSelectorConfig, seed: int = 0,
                device: str | torch.device = "cuda"):
    """Build the configured encoder on `device`, initialised from a
    seeded generator."""
    return build_encoder(cfg.variant_cfg, seed=seed, device=device)
