"""Encoder registry: name -> encoder variant (torch port of
`spfsplatv2_tpu/models/__init__.py`).

`EncoderSelectorConfig` is the config-side selector (the YAML/CLI
surface is `encoder.name=... encoder.<name>.<field>=...`) and
`get_encoder` builds the chosen variant.  Only the flagship
"spfsplatv2" is ported; "spfsplat" (v1) and "spfsplatv2l" (VGGT-1B)
load their configs and raise when built.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config, build_encoder
from spfsplatv2_tpu_torch.models.variant_configs import (
    SPFSplatConfig,
    SPFSplatV2LConfig,
)

ENCODERS = ("spfsplat", "spfsplatv2", "spfsplatv2l")
_NOT_PORTED = {
    "spfsplat": "the SPFSplat v1 encoder is not ported (ROADMAP.md item 17)",
    "spfsplatv2l": "the VGGT-1B encoder is not ported (ROADMAP.md item 16)",
}


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
    seeded generator (`models.encoder.build_encoder`)."""
    variant = cfg.variant_cfg
    if cfg.name in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[cfg.name])
    return build_encoder(variant, seed=seed, device=device)
