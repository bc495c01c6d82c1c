"""The port's hand-written CUDA kernels against their plain versions.

The `cuda`-marked tests need an NVIDIA GPU and nvcc and skip without
them.  This file imports torch and the port only (no JAX), so that on a
machine with the card it runs on its own:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spfsplatv2_tpu_torch.ops.covariance import build_covariance
from spfsplatv2_tpu_torch.ops.raster_common import project_gaussians
from spfsplatv2_tpu_torch.ops.raster_cuda import (
    NUM_FIELDS,
    composite_forward_cuda,
    composite_forward_plain,
)
from spfsplatv2_tpu_torch.ops.raster_tiled import bin_gaussians_prefix
from spfsplatv2_tpu_torch.ops.segscan import cumsum_1d_cuda

sys.path.insert(0, str(Path(__file__).parent))
from torch_port_common import (  # noqa: E402
    CAMERA_K,
    assert_images_close,
    cuda_device,  # noqa: F401  (fixture)
    np_scene,
    to_torch,
)

HW = (48, 48)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on CPU."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        cumsum_1d_cuda(torch.ones(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        composite_forward_cuda(torch.zeros(4, NUM_FIELDS),
                               torch.zeros(8, dtype=torch.int32),
                               torch.zeros(9, dtype=torch.int32),
                               torch.zeros(9, dtype=torch.int32), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1024, 4099, 131072, 1 << 21])
def test_cumsum_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    xi = torch.from_numpy(rng.integers(-3, 9, n).astype(np.int32)).to(cuda_device)
    assert torch.equal(cumsum_1d_cuda(xi), torch.cumsum(xi, 0).to(torch.int32))
    xf = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(cuda_device)
    # Float32 sums in two orders: within 1e-5 of the running sum of |x|.
    scale = torch.cumsum(xf.abs(), 0)
    err = (cumsum_1d_cuda(xf) - torch.cumsum(xf, 0)).abs()
    assert bool((err <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("base,cov_scale", [(None, 1.0), (2, 4.0)])
def test_composite_kernel_matches_plain(cuda_device, base, cov_scale):
    means, scales, quats, harm, op = map(
        lambda a: to_torch(a).to(cuda_device), np_scene(0, 300, cov_scale=cov_scale))
    covs = build_covariance(scales, quats)
    proj = project_gaussians(means, covs, harm, op, torch.eye(4, device=cuda_device),
                             to_torch(CAMERA_K).to(cuda_device), HW)
    bins = bin_gaussians_prefix(proj, HW, 32, 64, 300 * 32,
                                base_tiles_per_gaussian=base)
    depth = torch.where(torch.isfinite(proj.depth), proj.depth, 0.0)
    packed = torch.cat([proj.xy, proj.conic, proj.color, proj.opacity[:, None],
                        depth[:, None]], -1).contiguous()
    args = (packed, bins.src, bins.counts, bins.starts, bins.num_tiles_xy[1])
    out = composite_forward_cuda(*args)
    torch.cuda.synchronize()
    plain = composite_forward_plain(*args)
    for sl, atol, hard in ((slice(0, 3), 3e-5, 5e-3), (slice(3, 4), 3e-4, 2e-2),
                           (slice(4, 6), 3e-5, 5e-3)):
        assert_images_close(out[..., sl].cpu(), plain[..., sl].cpu(),
                            atol=atol, hard_atol=hard)
    assert float(out[..., 6:].abs().max()) == 0.0


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, imports in a process
    where jax, flax and the JAX package cannot be imported."""
    import subprocess
    import textwrap

    repo = Path(__file__).resolve().parents[1]
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(repo)!r})
        BLOCKED = ("jax", "jaxlib", "flax", "spfsplatv2_tpu")
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import spfsplatv2_tpu_torch
        for m in pkgutil.walk_packages(spfsplatv2_tpu_torch.__path__,
                                       "spfsplatv2_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        print("imported", len(sys.modules))
    """)
    proc = subprocess.run([sys.executable, "-I", "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout
