"""Wall-clock benchmarker + device memory stats (torch port of
`spfsplatv2_tpu/evaluation/benchmarker.py`).

On CUDA the timer synchronises the device before reading the clock at
both ends, so a tag's time covers the device work enqueued inside it.
`dump_memory` writes the card's peak, current and total bytes (all None
off the card).
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

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

    def dump(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.summarize(), indent=2))

    def dump_memory(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        stats = {"peak_bytes_in_use": None, "bytes_in_use": None,
                 "bytes_limit": None}
        if self.device.type == "cuda":
            stats = {
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(self.device),
                "bytes_in_use": torch.cuda.memory_allocated(self.device),
                "bytes_limit": torch.cuda.mem_get_info(self.device)[1],
            }
        path.write_text(json.dumps({"device_0": stats}, indent=2))

    def clear(self) -> None:
        self.execution_times.clear()
