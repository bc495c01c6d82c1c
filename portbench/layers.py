"""The traced segment split by the program's layers.

    python3 portbench/layers.py --workload <cell> --seed <n> --seconds <s> [--out PATH]

Runs the cell as `run.py --trace 1` does and prints the same result line
on standard output; then charges the traced segment to the port's
`spfsplat:` spans (`spfsplatv2_tpu_torch/utils/profiling.py:span`),
prints a table of the layers sorted by time on standard error, and a
last JSON line with the table and the per-layer values that `METRICS`
names.  `--out` (default `outputs/layers/<cell>-<seed>.json`) keeps
the same JSON.

How the segment is charged (`split`):
- A device operation (kernel, memcpy, memset) belongs to the innermost
  span that holds its launch: the runtime call with the same
  `correlation`, on the launching thread.  A launch inside an autograd
  node (`autograd::engine::evaluate_function: ...`) is backward work: it
  belongs to the span that held the forward operation with the node's
  `Sequence number` (the operation that made the node), unless a span
  opened inside the node holds it (remat's recompute entering the
  program's spans again), which then takes it.
- An idle gap (the edges of `trace.py`) belongs to the host operation
  that `trace.read` labels it with, by the same rules; a gap with no
  host operation to the innermost span that holds its middle.
- Anything else, and whatever no span holds, is `other`: the harness,
  its copies and syncs.
The profiler stretches host time, so idle time is scaled by one factor
`k` a segment, chosen so that the layers and `other` sum to the untraced
window's seconds an item (as `device.idle.*` divide by them).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import trace  # noqa: E402

PROGRAM = "spfsplat:"
NODE = "autograd::engine::evaluate_function: "
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
SEGMENT = trace.SPAN_PREFIX + "segment"
OTHER = "other"
FWD, BWD = "fwd", "bwd"
TOP = 4     # device operations listed a layer
# Per-layer values (ms an item, a layer's busy + idle): cell kind, span
# name prefixes, directions.
METRICS = {
    "train.encoder_fwd_ms": ("train", ("encoder.",), (FWD,)),
    "train.encoder_bwd_ms": ("train", ("encoder.",), (BWD,)),
    "train.render_ms": ("train", ("decoder.render", "render."), (FWD, BWD)),
    "train.loss_ms": ("train", ("loss.",), (FWD, BWD)),
    "train.optimizer_ms": ("train", ("train.optimizer",), (FWD, BWD)),
    "serve.backbone_ms": ("serve", ("encoder.backbone",), (FWD, BWD)),
    "serve.heads_ms": ("serve", ("encoder.heads",), (FWD, BWD)),
    "serve.render_ms": ("serve", ("decoder.render", "render."), (FWD, BWD)),
}


@dataclass
class Cost:
    """One layer's share of an item, forward or backward."""

    busy_ms: float = 0.0
    idle_ms: float = 0.0
    launches: float = 0.0
    syncs: float = 0.0
    top: list = field(default_factory=list)   # [name, busy ms] of its ops

    @property
    def ms(self) -> float:
        return self.busy_ms + self.idle_ms


@dataclass
class Split:
    item_ms: float        # the untraced window's ms an item
    k: float              # the idle time's scale
    layers: dict = field(default_factory=dict)   # (layer, fwd|bwd) -> Cost

    def table(self) -> list[dict]:
        rows = [{"layer": name, "dir": d, "ms": c.ms, "busy_ms": c.busy_ms,
                 "idle_ms": c.idle_ms, "launches": c.launches,
                 "syncs": c.syncs, "top": c.top}
                for (name, d), c in self.layers.items()]
        return sorted(rows, key=lambda r: -r["ms"])

    def metric(self, name: str) -> float | None:
        """`METRICS[name]`'s ms an item; None where no such span ran."""
        _, prefixes, dirs = METRICS[name]
        hits = [c.ms for (layer, d), c in self.layers.items()
                if d in dirs and layer.startswith(prefixes)]
        return sum(hits) if hits else None


class _Threads:
    """The segment's host events by thread, and the layer of a point."""

    def __init__(self):
        self.spans = defaultdict(list)   # tid -> (start, end, layer)
        self.nodes = defaultdict(list)   # tid -> (start, end, seq)
        self.ops = defaultdict(list)     # tid -> (start, end, name)
        self.forward = []                # (tid, start, seq)
        self.creator = {}                # seq -> (tid, start)

    def index(self) -> None:
        """Each sequence number's last forward operation outside autograd
        nodes: the one that made the node."""
        inside = self._holding(self.nodes, [(t, s) for t, s, _ in
                                            self.forward])
        for (tid, s, seq), node in zip(self.forward, inside):
            if node is None and s >= self.creator.get(seq, (None, -1))[1]:
                self.creator[seq] = (tid, s)

    @staticmethod
    def _holding(intervals: dict, queries: list) -> list:
        """For each (tid, t): (start, payload) of the innermost of that
        thread's intervals that holds t, or None."""
        out = [None] * len(queries)
        by_tid = defaultdict(list)
        for i, (tid, t) in enumerate(queries):
            by_tid[tid].append((t, i))
        for tid, pts in by_tid.items():
            pts.sort()
            found = trace._innermost(intervals.get(tid, []),
                                     [t for t, _ in pts], starts=True)
            for (_, i), f in zip(pts, found):
                out[i] = f
        return out

    def layers(self, queries: list) -> list:
        """For each (tid, t): (layer, fwd|bwd)."""
        spans = self._holding(self.spans, queries)
        nodes = self._holding(self.nodes, queries)
        out, pending = [], []
        for i, (sp, node) in enumerate(zip(spans, nodes)):
            if node is None:
                out.append((sp[1] if sp else OTHER, FWD))
            elif sp is not None and sp[0] >= node[0]:
                out.append((sp[1], BWD))
            else:
                out.append((OTHER, BWD))
                origin = self.creator.get(node[1])
                if origin is not None:
                    pending.append((i, origin))
        for (i, _), sp in zip(pending, self._holding(
                self.spans, [o for _, o in pending])):
            if sp is not None:
                out[i] = (sp[1], BWD)
        return out

    def holder(self, t: int):
        """The thread whose innermost span holding t started last."""
        best = None
        for tid, found in zip(self.spans, (
                trace._innermost(iv, [t], starts=True)[0]
                for iv in self.spans.values())):
            if found is not None and (best is None or found[0] > best[0]):
                best = (found[0], tid)
        return None if best is None else best[1]


def split(events: list, items: int, item_s: float) -> Split:
    """Charge a traced segment's events (Chrome-trace complete events, as
    `trace._events` returns them) to the program's layers; every value
    per item, idle scaled to the untraced `item_s`."""
    threads = _Threads()
    device, runtime, syncs, segment = [], {}, [], None
    for ev in events:
        cat, name = ev.get("cat", ""), ev.get("name", "")
        args = ev.get("args") or {}
        s = int(float(ev["ts"]) * 1000)
        e = s + int(float(ev["dur"]) * 1000)
        tid = ev.get("tid")
        if cat in trace.DEVICE_CATS:
            device.append((s, e, args.get("correlation"), name[:100]))
        elif cat in RUNTIME_CATS:
            runtime[args.get("correlation")] = (tid, s)
            if name in SYNCS:
                syncs.append((tid, s))
        elif cat == "user_annotation" and name.startswith(PROGRAM):
            threads.spans[tid].append((s, e, name[len(PROGRAM):]))
        elif cat == "user_annotation" and name == SEGMENT:
            segment = (s, e)
        elif cat == "cpu_op":
            threads.ops[tid].append((s, e, name))
            seq = args.get("Sequence number")
            if name.startswith(NODE):
                threads.nodes[tid].append((s, e, seq))
            elif seq is not None and not args.get("Fwd thread id"):
                threads.forward.append((tid, s, seq))
    threads.index()
    costs = defaultdict(lambda: [0, 0, 0, 0])   # busy ns, idle ns, ops, syncs
    by_op = defaultdict(lambda: defaultdict(int))   # key -> name -> busy ns

    # Device time: each operation's part of the union, in start order.
    device.sort()
    launched = [runtime.get(c) for _, _, c, _ in device]
    where = iter(threads.layers([q for q in launched if q is not None]))
    cursor = busy = 0
    for (s, e, _, name), q in zip(device, launched):
        key = next(where) if q is not None else (OTHER, FWD)
        part = max(0, e - max(s, cursor))
        cursor = max(cursor, e)
        costs[key][0] += part
        costs[key][2] += 1
        by_op[key][name] += part
        busy += part
    for key in threads.layers(syncs):
        costs[key][3] += 1

    # Idle gaps, labelled as trace.read labels them.
    merged = trace._union([(s, e) for s, e, _, _ in device])
    edges = [(merged[k][1], merged[k + 1][0]) for k in range(len(merged) - 1)]
    if segment and merged:
        edges = ([(segment[0], merged[0][0])] + edges
                 + [(merged[-1][1], segment[1])])
    gaps = sorted(((a + b) // 2, b - a) for a, b in edges if b > a)
    points = [m for m, _ in gaps]
    found = {tid: trace._innermost(ops, points, starts=True)
             for tid, ops in threads.ops.items()}
    queries = []
    for k, (mid, _) in enumerate(gaps):
        op = max(((f[k][0], f[k][1], tid) for tid, f in found.items()
                  if f[k]), default=None)
        tid = op[2] if op else threads.holder(mid)
        queries.append((tid, mid) if tid is not None else None)
    idle = sum(length for _, length in gaps)
    where = iter(threads.layers([q for q in queries if q is not None]))
    for (_, length), q in zip(gaps, queries):
        costs[next(where) if q is not None else (OTHER, FWD)][1] += length

    item_ms = item_s * 1e3
    busy_ms, idle_ms = busy / 1e6 / items, idle / 1e6 / items
    k = (item_ms - busy_ms) / idle_ms if idle_ms > 0 else 0.0
    out = Split(item_ms=item_ms, k=k)
    for key, (b, i, n, sy) in costs.items():
        top = sorted(by_op[key].items(), key=lambda kv: -kv[1])[:TOP]
        out.layers[key] = Cost(b / 1e6 / items, k * i / 1e6 / items,
                               n / items, sy / items,
                               [[name, ns / 1e6 / items] for name, ns in top])
    return out


@contextlib.contextmanager
def kept_events():
    """The event lists that `trace.read` exports while in the body (it
    keeps none itself): the list it gets from `trace._events`."""
    kept, export = [], trace._events

    def keep(prof):
        kept.append(export(prof))
        return kept[-1]

    trace._events = keep
    try:
        yield kept
    finally:
        trace._events = export


def report(cell, sp: Split) -> dict:
    """The split as one JSON object: the table, its sum and `other`'s
    share, and the cell kind's values of `METRICS`."""
    rows = sp.table()
    total = sum(r["ms"] for r in rows)
    other = sum(r["ms"] for r in rows if r["layer"] == OTHER)
    metrics = {name: sp.metric(name) for name, (kind, _, _) in
               METRICS.items() if kind == cell.traffic["kind"]}
    return {"workload": cell.name, "item_ms": sp.item_ms, "k": sp.k,
            "sum_ms": total, "other_share": other / total if total else None,
            "metrics": metrics, "layers": rows}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    from portbench import harness, run  # run: build caches, result line

    import torch

    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 3
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    with kept_events() as kept:
        outcome = harness.run_cell(cell, args.seed, args.seconds, True,
                                   device, T_START, log)
    run.report(cell, outcome, True, {"platform": "gpu", "count": 1,
                                     "kind": torch.cuda.get_device_name(0)})
    r = outcome.readings
    result = report(cell, split(kept[-1], r.trace.items, r.window_s / r.items))
    log(f"layers of {cell.name}: an item {result['item_ms']:.3f} ms "
        f"untraced, layers sum {result['sum_ms']:.3f} ms, "
        f"idle x{result['k']:.4f}")
    log(f"{'layer':<22}{'dir':<5}{'ms':>10}{'busy':>10}{'idle':>10}"
        f"{'launches':>10}{'syncs':>7}")
    for row in result["layers"]:
        log(f"{row['layer']:<22}{row['dir']:<5}{row['ms']:>10.3f}"
            f"{row['busy_ms']:>10.3f}{row['idle_ms']:>10.3f}"
            f"{row['launches']:>10.1f}{row['syncs']:>7.1f}")
        for name, ms in row["top"]:
            log(f"{'':<27}{ms:>10.3f}  {name[:70]}")
    out = Path(args.out or ROOT / "outputs" / "layers"
               / f"{cell.name}-{args.seed}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
