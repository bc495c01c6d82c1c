"""Metric and image logging: JSONL scalars, PNG and GIF files (torch port
of `spfsplatv2_tpu/utils/logger.py`).

Scalars stream to `<output_dir>/metrics.jsonl`, images to
`images/<name>_<step>.png` and videos to `videos/<name>_<step>.gif`
through `utils/visualization.py`.  A `wandb` backend engages where the
package imports and holds an API key.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


def _host(image) -> np.ndarray:
    """A float (h, w, 3) image as a host numpy array (tensors on any
    device are copied over)."""
    if hasattr(image, "detach"):
        image = image.detach().float().cpu().numpy()
    return np.asarray(image)


class LocalLogger:
    def __init__(self, output_dir: str | Path, flush_every: int = 20):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.dir / "metrics.jsonl", "a")
        self._since_flush = 0
        self._flush_every = flush_every
        self._wandb = None
        try:
            import wandb
        except ImportError:
            wandb = None
        if wandb is not None and wandb.api.api_key:
            self._wandb = wandb

    def log_scalars(self, step: int, scalars: dict) -> None:
        record = {"step": step, "time": time.time(), **scalars}
        self._file.write(json.dumps(record) + "\n")
        self._since_flush += 1
        if self._since_flush >= self._flush_every:
            self._file.flush()
            self._since_flush = 0
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def log_image(self, step: int, name: str, image) -> None:
        from spfsplatv2_tpu_torch.utils.visualization import save_image

        save_image(_host(image),
                   self.dir / "images" / f"{name}_{step:08d}.png")

    def log_video(self, step: int, name: str, frames: list) -> None:
        from spfsplatv2_tpu_torch.utils.visualization import save_video

        save_video([_host(f) for f in frames],
                   self.dir / "videos" / f"{name}_{step:08d}.gif")

    def close(self) -> None:
        self._file.close()
