"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package,
and its reference loads nothing of the port (top-level names compared
whole: the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "spfsplatv2_tpu"}

# Blocks the forbidden imports outright, runs one tiny training and one
# tiny serving cell on the CPU through the harness, loads every metric
# reader and the FLOP counter, and prints the loaded top-level names.
DRIVER = """
import importlib.abc, json, sys, torch
FORBIDDEN = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
torch.set_num_threads(2)
from portbench import calibrate, faults, flops, harness, roofline, run, trace
from portbench.tests.tiny import tiny_cell
for w in ("v2-train-256-b16", "v2-serve-256"):
    cell = tiny_cell(w, {"limits": {}})
    out = harness.run_cell(cell, 7, 0.0, True, torch.device("cpu"), 0.0,
                           log=lambda s: None)
    harness.metrics_of(cell, out.readings, True)
    harness.metrics_of(cell, out.readings, False)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_portbench_loads_no_jax():
    code = DRIVER % (sorted(FORBIDDEN), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "spfsplatv2_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_portbench_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for path in files:
        bad = _imports(path) & (FORBIDDEN | {"spfsplatv2_tpu_torch"})
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    code = ("import sys, pkgutil, importlib; sys.path.insert(0, %r); "
            "import portbench.reference as r; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(r.__path__, 'portbench.reference.')]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"spfsplatv2_tpu_torch"})


def test_portbench_harness_reads_no_jax_records():
    """The harness reads no file of the JAX package's benchmark records."""
    for path in sorted(BENCH.rglob("*.py")):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        text = path.read_text()
        for name in ("bench.py", "benchmarks/", "BENCH_r0", "BASELINE.json"):
            assert name not in text, f"{path.relative_to(ROOT)} names {name}"
