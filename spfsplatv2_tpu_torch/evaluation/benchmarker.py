"""Wall-clock benchmarker (torch port of the timer of
`spfsplatv2_tpu/evaluation/benchmarker.py`).

On CUDA the timer synchronises the device before reading the clock at
both ends, so a tag's time covers the device work enqueued inside it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class Benchmarker:
    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.execution_times: dict[str, list[float]] = defaultdict(list)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def time(self, tag: str, num_calls: int = 1):
        self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            elapsed = time.perf_counter() - start
            for _ in range(num_calls):
                self.execution_times[tag].append(elapsed / num_calls)

    def summarize(self) -> dict:
        return {
            tag: {"mean_s": sum(ts) / len(ts), "count": len(ts),
                  "total_s": sum(ts)}
            for tag, ts in self.execution_times.items()
        }
