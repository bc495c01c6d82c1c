"""Profiling helpers: device traces and per-step wall timing (torch port
of `spfsplatv2_tpu/utils/profiling.py`).

`trace()` wraps a region in `torch.profiler` over the CPU and, where
there is one, the CUDA device, and writes a Chrome trace (open it in
Perfetto or chrome://tracing) into `log_dir` on exit; `StepTimer` keeps
rolling step times.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path


@contextmanager
def trace(log_dir: str | Path = "outputs/profile"):
    """Profile the body; yields the profiler.  The trace is written to
    `<log_dir>/trace.json` when the body returns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class StepTimer:
    """Rolling per-step wall-time tracker (wandb `time/step_time` analog)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float | None:
        return sum(self._times) / len(self._times) if self._times else None

    @property
    def steps_per_s(self) -> float | None:
        m = self.mean
        return (1.0 / m) if m else None
