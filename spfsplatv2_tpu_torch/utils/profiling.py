"""Profiling helpers: device traces and the program's spans (torch port of
`spfsplatv2_tpu/utils/profiling.py`).

`trace()` wraps a region in `torch.profiler` over the CPU and, where
there is one, the CUDA device, and writes a Chrome trace (open it in
Perfetto or chrome://tracing) into `log_dir` on exit.  `span(name)` marks
one layer of the program ("spfsplat:<name>" in the trace) while a
profiler records, and costs one flag test otherwise.  `device_ops` and
`busy_us` read a written trace: the card's kernels, memcpys and memsets,
and the union of their intervals.
"""

from __future__ import annotations

import contextlib
import json
from contextlib import contextmanager
from pathlib import Path

import torch

SPAN_PREFIX = "spfsplat:"
# The trace's categories of work on the card; annotations are not work.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_OFF = contextlib.nullcontext()


def span(name: str):
    """`record_function("spfsplat:" + name)` while a profiler records, a
    shared no-op context otherwise (an unguarded `record_function` costs
    ~10x more with no profiler on)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _OFF


@contextmanager
def trace(log_dir: str | Path = "outputs/profile"):
    """Profile the body; yields the profiler.  The trace is written to
    `<log_dir>/trace.json` when the body returns."""
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


def device_ops(trace_path: str | Path) -> list[tuple[float, float, str]]:
    """(start_us, end_us, name) of each kernel, memcpy and memset on the
    card in a Chrome trace that `trace` wrote."""
    data = json.loads(Path(trace_path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_us(ops) -> float:
    """The length of the union of the operations' intervals: the card's
    busy time, overlapping operations counted once."""
    total, end = 0.0, float("-inf")
    for s, e, _ in sorted(ops):
        if e > end:
            total += e - max(s, end)
            end = e
    return total
