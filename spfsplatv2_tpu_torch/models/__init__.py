"""Encoder registry: name -> encoder variant (torch port of
`spfsplatv2_tpu/models/__init__.py`).

`EncoderSelectorConfig` is the config-side selector (the YAML/CLI
surface is `encoder.name=... encoder.<name>.<field>=...`) and
`get_encoder` builds the chosen variant: "spfsplat" (v1, the unmasked
CroCo backbone), the flagship "spfsplatv2" (masked CroCo backbone) or
"spfsplatv2l" (VGGT-1B).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from spfsplatv2_tpu_torch.models import encoder, encoder_spfsplat, encoder_vggt
from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config
from spfsplatv2_tpu_torch.models.encoder_spfsplat import SPFSplatConfig
from spfsplatv2_tpu_torch.models.encoder_vggt import SPFSplatV2LConfig

_BUILDERS = {"spfsplat": encoder_spfsplat.build_encoder,
             "spfsplatv2": encoder.build_encoder,
             "spfsplatv2l": encoder_vggt.build_encoder}
ENCODERS = tuple(_BUILDERS)


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


def get_encoder(cfg: EncoderSelectorConfig, seed: int = 0,
                device: str | torch.device = "cuda"):
    """Build the configured encoder on `device`, initialised from a
    seeded generator (each variant's `build_encoder`)."""
    return _BUILDERS[cfg.name](cfg.variant_cfg, seed=seed, device=device)
