"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface (`build/kernels/lib<name>-<hash>
.so`, the hash taken over the source and the shared `csrc/*.cuh` headers,
so an edited source is rebuilt) and loaded with `ctypes`.  The build
happens at first use; `build_all()` starts one `nvcc` per source, all at
once.  Nothing here runs at import.

`launch_counts` holds one plain integer per kernel.  Each wrapper adds one
where it launches its kernel (or records the launch into a CUDA graph
being captured), and nowhere else, so a run can show that its main path
went through the kernels.  A graph's replay calls no wrapper: the kernels
it launches show in a device trace only.  Two more count the encoder's
inference forwards that took its CUDA graphs (`utils/cuda_graph.py`):
`encoder_graph_replay`, the replays, and `encoder_graph_eager`, the
first call of each input signature, run eagerly before its capture.
One more counts no launch: `masked_attn_logits`, the float32 logits that
`ops/attention.py:sdpa_view_masked` writes densely (b h n_q n_k a call of
its dense or query-chunked branch, on every device; its kernel's branch
writes none), which the benchmark reads as bytes a request.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
# name -> (C function, argtypes); every function returns cudaGetLastError().
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
SIGNATURES = {
    "prefix_scan": {
        "spf_cumsum_i32": [_P, _P, _P, _L, _I, _P],
        "spf_cumsum_f32": [_P, _P, _P, _L, _I, _P],
    },
    "composite_forward": {
        "spf_composite_forward": [_P, _P, _P, _P, _I, _I, _P, _P],
    },
    "composite_backward": {
        "spf_composite_backward": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    },
    "segmented_scan": {
        "spf_segmented_scan": [_P, _P, _P, _P, _I, _L, _P],
    },
    "flash_forward": {
        "spf_flash_forward": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    },
    "flash_backward_dkv": {
        "spf_flash_backward_dkv": [_P] * 8 + [_I, _I, _I, _F, _P],
    },
    "flash_backward_dq": {
        "spf_flash_backward_dq": [_P] * 7 + [_I, _I, _I, _F, _P],
    },
    "flash_f32_forward": {
        "spf_flash_f32_forward": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    },
    "flash_f32_split": {
        "spf_flash_f32_split": [_P] * 11 + [_I, _I, _I, _P],
        "spf_flash_f32_split_forward": [_P] * 4 + [_I, _I, _P],
    },
    "flash_f32_backward_dkv": {
        "spf_flash_f32_backward_dkv": [_P] * 10 + [_I, _I, _I, _F, _P],
    },
    "flash_f32_backward_dq": {
        "spf_flash_f32_backward_dq": [_P] * 8 + [_I, _I, _I, _F, _P],
    },
    "flash_view_masked": {
        "spf_flash_view_masked": [_P] * 6 + [_I] * 6 + [_F, _P],
    },
    # Not a path kernel: each kind of wgmma product of K5's backward
    # alone, for the tests (no launch count).
    "wgmma_check": {
        "spf_wgmma_check": [_P, _P, _P, _I, _I, _I, _P],
    },
    # Not a path kernel either: each kind of 3xTF32 product of K5's
    # float32 backward alone, for the tests (no launch count).
    "wgmma_tf32_check": {
        "spf_wgmma_tf32_check": [_P, _P, _P, _I, _I, _P],
    },
}

launch_counts: dict[str, int] = {
    "composite_forward": 0, "composite_backward": 0, "cumsum_1d": 0,
    "segmented_scan": 0, "flash_forward": 0, "flash_backward_dkv": 0,
    "flash_backward_dq": 0, "flash_f32_forward": 0,
    "flash_f32_split_forward": 0, "flash_f32_split": 0,
    "flash_f32_backward_dkv": 0, "flash_f32_backward_dq": 0,
    "flash_view_masked": 0, "encoder_graph_replay": 0,
    "encoder_graph_eager": 0, "masked_attn_logits": 0,
}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def launches() -> dict[str, int]:
    """A copy of `launch_counts` less `masked_attn_logits`: the calls that
    a phase or a test expects by number."""
    return {k: v for k, v in launch_counts.items()
            if k != "masked_attn_logits"}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every missing library in parallel; returns name -> nvcc log.

    Raises RuntimeError naming each source that failed to compile.
    """
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all([name])
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def stream_handle(device: torch.device) -> int:
    """The current stream's handle on `device`.  The raw query skips the
    `torch.cuda.Stream` object that `current_stream` builds, which costs
    several microseconds a call (K3's whole kernel takes about four)."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given type/rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{t.device}")
    if t.device != device or t.dtype != dtype or t.ndim != ndim:
        raise ValueError(
            f"{name}: expected {ndim}-d {dtype} on {device}, got "
            f"{t.ndim}-d {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
