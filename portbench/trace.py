"""Reading a `torch.profiler` trace of the traced segment.

Device time is the union of the kernel, memcpy and memset intervals on
the card; user annotations (the optimizer's span, the harness's own
`portbench:*` spans) are not device work and are left out.  Each idle
gap between device intervals is labelled by what the host was doing at
its middle: the innermost harness span and the host operation, of any
thread, that started last among those running then.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

SPAN_PREFIX = "portbench:"
TOP = 10


@dataclass
class Trace:
    window_s: float                      # the segment's host-clock length
    items: int                           # steps or requests in it
    device: list = field(default_factory=list)   # (start_ns, end_ns, name)
    activity_kinds: dict = field(default_factory=dict)
    busy_s: float = 0.0
    gaps: list = field(default_factory=list)     # (seconds, label)

    def time_by_name(self, part: str) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        `part`."""
        hits = [e - s for s, e, n in self.device if part in n]
        return sum(hits) / 1e9, len(hits)

    def breakdown(self) -> dict:
        by_op = defaultdict(float)
        for s, e, n in self.device:
            by_op[n[:120]] += (e - s) / 1e9
        by_gap = defaultdict(float)
        for sec, label in self.gaps:
            by_gap[label] += sec
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(intervals, points, starts: bool = False):
    """For each sorted point, the name of the latest-starting interval
    that holds it (with `starts`: (start, name)), among properly nested
    (start, end, name) intervals."""
    out, stack, i = [], [], 0
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    for t in points:
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        top = stack[-1] if stack else None
        out.append(None if top is None else
                   (top[0], top[2]) if starts else top[2])
    return out


def _events(prof) -> list[dict]:
    """The trace's complete events, through its Chrome-trace export (the
    one form whose categories every recent torch writes alike)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def read(prof, window_s: float, items: int) -> Trace:
    trace = Trace(window_s=window_s, items=items)
    host, spans = [], []
    for ev in _events(prof):
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = int(float(ev["ts"]) * 1000)
        row = (s, s + int(float(ev["dur"]) * 1000), name)
        if cat.startswith("gpu_") or cat == "kernel":
            trace.activity_kinds[cat] = trace.activity_kinds.get(cat, 0) + 1
            if cat in DEVICE_CATS:
                trace.device.append(row)
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append(row)
        elif cat == "cpu_op":
            host.append((*row, ev.get("tid")))
    merged = _union([(s, e) for s, e, _ in trace.device])
    trace.busy_s = sum(e - s for s, e in merged) / 1e9
    segment = [r for r in spans if r[2] == SPAN_PREFIX + "segment"]
    edges = []
    if segment and merged:
        edges = [(segment[0][0], merged[0][0])]
    edges += [(merged[k][1], merged[k + 1][0]) for k in range(len(merged) - 1)]
    if segment and merged:
        edges.append((merged[-1][1], segment[0][1]))
    edges = [(a, b) for a, b in edges if b > a]
    mids = sorted(((a + b) // 2, b - a) for a, b in edges)
    points = [m for m, _ in mids]
    in_span = _innermost([r for r in spans if r[2] != SPAN_PREFIX + "segment"],
                         points)
    # Per host thread (the backward runs on autograd's own), then the op
    # that started last among those that hold the point.
    threads = defaultdict(list)
    for s, e, n, tid in host:
        threads[tid].append((s, e, n))
    found = [_innermost(ops, points, starts=True)
             for ops in threads.values()]
    in_op = [max((f[k] for f in found if f[k]), default=(0, None))[1]
             for k in range(len(points))]
    for (mid, length), span, op in zip(mids, in_span, in_op):
        span = span[len(SPAN_PREFIX):] if span else "between"
        trace.gaps.append((length / 1e9, f"{span}:{op or 'host'}"))
    return trace
