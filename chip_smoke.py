#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`spfsplatv2_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, on a machine with a card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. environment: torch, the card, its power limit, the TF32 settings;
  2. build: every kernel of the serving path, compiled from `csrc/` with
     one `nvcc` per source, all started together;
  3. K3 (`cumsum_1d`, csrc/prefix_scan.cu) against its plain version
     (int32 exact) at the main path's n and a ragged n, timed beside
     `torch.cumsum`;
  4. K1 (`composite_forward`, csrc/composite_forward.cu) against its plain
     version on a pixel-aligned 131072-Gaussian scene at 256^2, binned by
     the port, and against the dense oracle on a 64^2 scene;
  5. the main path: the full-width `spfsplatv2` encoder (ViT-L 24x1024,
     decoders 2x12x768, DPT 256/128, SH degree 4, bf16 compute) from a
     seeded random init, serving 3 requests (2 context views + 1 target
     at 256^2) through `evaluate_example`, with the kernels' launch
     counts read around exactly those requests; the first request's
     render is held against the port's CPU path (the kernels' plain
     versions) on the same Gaussians.
  6. where the time goes: the decoder's stages and the encoder's backbone
     timed apart with CUDA events.
Then the kernels line (each kernel's times, bound, launches on the main
path and check results), the card's name and power limit, and the
result.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12      # FP32 outside the tensor cores, same source
# FP32 operations per (pixel, entry) pair in K1: every walked pair pays
# dx, dy and the power (11), exp, scale and clamp (3); a blended pair adds
# the transmittance test (2), its weight (1) and 4 accumulations (8).
K1_OPS_WALKED, K1_OPS_BLENDED = 14, 11


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def pixel_aligned_scene(torch, views: int, hw: int, gen, dev, d_sh=25,
                        opacity=(0.05, 0.95)):
    """`views` x hw^2 Gaussians unprojected from per-view pixel grids at
    random depths, each about one pixel wide (the encoder's layout)."""
    from spfsplatv2_tpu_torch.ops.covariance import build_covariance

    ys, xs = torch.meshgrid(torch.arange(hw, device=dev),
                            torch.arange(hw, device=dev), indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 2).float()
    means = []
    for v in range(views):
        depth = 2.0 + 3.0 * torch.rand(hw * hw, 1, generator=gen, device=dev)
        cam = torch.cat([(pix - (hw - 1) / 2) / hw * depth, depth], -1)
        means.append(cam + torch.tensor([0.15 * v, 0.0, 0.0], device=dev))
    means = torch.cat(means)
    g = means.shape[0]
    rnd = lambda *s: torch.rand(*s, generator=gen, device=dev)
    scales = means[:, 2:3] / hw * (0.5 + rnd(g, 3))
    quats = torch.randn(g, 4, generator=gen, device=dev)
    covs = build_covariance(scales, quats)
    harm = 0.3 * torch.randn(g, 3, d_sh, generator=gen, device=dev)
    opac = opacity[0] + (opacity[1] - opacity[0]) * rnd(g)
    return means, covs, harm, opac


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from spfsplatv2_tpu_torch.evaluation.benchmarker import Benchmarker
    from spfsplatv2_tpu_torch.evaluation.evaluator import (
        EvalConfig,
        disable_tf32,
        evaluate_example,
    )
    from spfsplatv2_tpu_torch.models.decoder import DecoderConfig, decode_splatting
    from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config, build_encoder
    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.ops.raster_common import project_gaussians
    from spfsplatv2_tpu_torch.ops.raster_cuda import (
        composite_forward_cuda,
        composite_forward_plain_work,
        composite_prefix,
    )
    from spfsplatv2_tpu_torch.ops.raster_ref import composite_reference
    from spfsplatv2_tpu_torch.ops.raster_tiled import bin_gaussians_prefix
    from spfsplatv2_tpu_torch.ops.rasterizer import entry_budget
    from spfsplatv2_tpu_torch.ops.segscan import (
        cumsum_1d_cuda,
        cumsum_1d_plain,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    disable_tf32()
    smi = nvidia_smi_line()

    # ---- 1. environment ------------------------------------------------
    emit({"phase": "environment", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_lib.build_all()
    for name in cuda_lib.SIGNATURES:
        cuda_lib.library(name)
    ptxas = [line.strip() for log in logs.values() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs), "ptxas": ptxas})

    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---- 3. K3: cumsum_1d ---------------------------------------------
    checks = []
    for n in (131072, 100003):
        xi = torch.randint(-3, 9, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
        ki, pi = cumsum_1d_cuda(xi), cumsum_1d_plain(xi)
        torch.cuda.synchronize()
        if not torch.equal(ki, pi):
            fail(f"K3 int32 differs from torch.cumsum at n={n}")
        xf = torch.rand(n, generator=gen, device=dev) * 2 - 1
        kf, pf = cumsum_1d_cuda(xf), cumsum_1d_plain(xf)
        errf = (kf - pf).abs()
        # Both sum in float32 in different orders: bound the gap by 1e-5
        # of the running magnitude sum(|x|).
        if not bool((errf <= 1e-5 * torch.cumsum(xf.abs(), 0) + 1e-6).all()):
            fail(f"K3 float32 outside 1e-5 * cumsum|x| at n={n}")
        checks.append({"n": n, "int32_exact": True,
                       "f32_max_abs_err": float(errf.max())})
    n = 131072
    x = torch.randint(0, 2, (n,), generator=gen, device=dev, dtype=torch.int32)
    k3 = {
        "ms": time_ms(torch, lambda: cumsum_1d_cuda(x), 200),
        "plain_ms": time_ms(torch, lambda: cumsum_1d_plain(x), 200),
        "library_ms": time_ms(
            torch, lambda: torch.cumsum(x, 0, dtype=torch.int32), 200),
        "max_abs_err": float((cumsum_1d_cuda(x) - cumsum_1d_plain(x))
                             .abs().max()),
        "bound_ms": max(2 * n * 4 / H100_BYTES_PER_S,
                        n / H100_FP32_PER_S) * 1e3,
        "bound_by": "bytes",
    }
    emit({"phase": "K3", "checks": checks, "n": n, "dtype": "int32", **k3,
          "note": "int32 0/1 flags as in the binning's pool rank"})

    # ---- 4. K1: composite_forward -------------------------------------
    hw = 256
    means, covs, harm, opac = pixel_aligned_scene(torch, 2, hw, gen, dev)
    g = means.shape[0]
    c2w = torch.eye(4, device=dev)
    c2w[0, 3] = 0.075
    k_norm = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], device=dev)
    proj = project_gaussians(means, covs, harm, opac, c2w, k_norm, (hw, hw))
    rcfg = DecoderConfig().rasterizer
    bins = bin_gaussians_prefix(
        proj, (hw, hw), rcfg.max_tiles_per_gaussian, rcfg.chunk,
        entry_budget(rcfg, g), rcfg.base_tiles_per_gaussian,
        rcfg.big_pool_factor, rcfg.depth_key,
    )
    packed = torch.cat([proj.xy, proj.conic, proj.color, proj.opacity[:, None],
                        torch.nan_to_num(proj.depth, posinf=0.0)[:, None]],
                       -1).contiguous()
    tiles_x = bins.num_tiles_xy[1]
    args = (packed, bins.src, bins.counts, bins.starts, tiles_x)
    out_k = composite_forward_cuda(*args)
    torch.cuda.synchronize()
    out_p, walked, blended = composite_forward_plain_work(*args)
    bars = {"color": (slice(0, 3), 3e-5, 5e-3), "depth": (slice(3, 4), 3e-4, 2e-2),
            "alpha": (slice(4, 5), 3e-5, 5e-3)}
    k1_check = {}
    for name, (sl, atol, hard) in bars.items():
        diff = (out_k[..., sl] - out_p[..., sl]).abs()
        outliers = int((diff > atol).any(-1).sum())
        frac_ok = 1.0 - outliers / diff.shape[0] / diff.shape[1]
        k1_check[name] = {"max_abs_err": float(diff.max()), "outliers": outliers}
        if float(diff.max()) > hard or frac_ok < 0.999:
            fail(f"K1 {name} vs plain: max {float(diff.max())}, "
                 f"{outliers} pixels over {atol}")
    n_live = int(bins.n_live)
    live_rows = int((bins.live_counts > 0).sum())
    n_tiles = bins.counts.shape[0]
    k1_bytes = n_live * 4 + live_rows * 40 + 2 * n_tiles * 4 + out_k.numel() * 4
    k1_ops = walked * K1_OPS_WALKED + blended * K1_OPS_BLENDED
    k1 = {
        "ms": time_ms(torch, lambda: composite_forward_cuda(*args), 50),
        "plain_ms": time_ms(torch, lambda: composite_forward_plain_work(*args),
                            3, warmup=1),
        "library_ms": None,
        "max_abs_err": max(v["max_abs_err"] for v in k1_check.values()),
        "bound_ms": max(k1_bytes / H100_BYTES_PER_S,
                        k1_ops / H100_FP32_PER_S) * 1e3,
        "bound_by": ("bytes" if k1_bytes / H100_BYTES_PER_S
                     >= k1_ops / H100_FP32_PER_S else "operations"),
    }
    # The dense oracle on a small scene (the full-size one needs ~34 GB).
    # Opacities stay below 0.35 so that no alpha above 1/255 lies outside
    # a Gaussian's 3-sigma tile box (op * exp(-4.5) < 1/255): the binning
    # then drops nothing the oracle composites, and the check isolates
    # the kernel.
    sm, sc, sh, so = pixel_aligned_scene(torch, 2, 32, gen, dev,
                                         opacity=(0.05, 0.34))
    sproj = project_gaussians(sm, sc, sh, so, c2w, k_norm, (64, 64))
    sbins = bin_gaussians_prefix(sproj, (64, 64), 16, 128, 16 * sm.shape[0], 4)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    ours = composite_prefix(sproj, sbins, (64, 64), bg)
    ref = composite_reference(sproj, (64, 64), bg)
    oracle = {}
    for name, a, b, atol, hard in (("color", ours[0], ref[0], 3e-5, 5e-3),
                                   ("depth", ours[1], ref[1], 3e-4, 2e-2),
                                   ("alpha", ours[2], ref[2], 3e-5, 5e-3)):
        diff = (a - b).abs()
        oracle[name] = float(diff.max())
        if float(diff.max()) > hard or float((diff <= atol).float().mean()) < 0.999:
            fail(f"K1 {name} vs the dense oracle: max {float(diff.max())}")
    emit({"phase": "K1", "g": g, "hw": hw, "n_live": n_live,
          "dropped_entries": int(bins.n_overflow), "e_pad": bins.e_pad,
          "pairs_walked": walked, "pairs_blended": blended,
          "vs_plain": k1_check, "vs_oracle_64px_max_abs_err": oracle,
          "bound_bytes": k1_bytes, "bound_ops": k1_ops, **k1})

    # ---- 5. main path: evaluate_example at full width -----------------
    t0 = time.perf_counter()
    cfg = SPFSplatV2Config()
    encoder = build_encoder(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in encoder.parameters())
    emit({"phase": "encoder_init", "seconds": time.perf_counter() - t0,
          "params": n_params, "compute_dtype": cfg.backbone.compute_dtype})

    def request(i: int) -> dict:
        r = torch.Generator(device=dev).manual_seed(1000 + i)
        k = k_norm.expand(1, 3, 3)

        def view(offset):
            c2w = torch.eye(4, device=dev)
            c2w[0, 3] = offset
            return {"image": torch.rand(1, hw, hw, 3, generator=r, device=dev),
                    "intrinsics": k.clone(), "extrinsics": c2w[None],
                    "near": torch.ones(1, device=dev),
                    "far": torch.full((1,), 100.0, device=dev)}

        ctx0, ctx1, tgt = view(0.0), view(0.2), view(0.1)
        ctx = {key: torch.cat([ctx0[key], ctx1[key]]) for key in ctx0}
        ctx["overlap"] = 0.5
        return {"scene": f"request_{i}", "context": ctx, "target": tgt}

    dec_cfg, eval_cfg = DecoderConfig(), EvalConfig()
    warm = evaluate_example(encoder, request(-1), (hw, hw), dec_cfg, eval_cfg,
                            device=dev)
    requests = [request(i) for i in range(3)]
    results = []
    cuda_lib.reset_launch_counts()
    for ex in requests:
        bench = Benchmarker(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = evaluate_example(encoder, ex, (hw, hw), dec_cfg, eval_cfg,
                               benchmarker=bench, device=dev)
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        res["times"] = bench.summarize()
        results.append(res)
    counts = dict(cuda_lib.launch_counts)
    cams = sum(r["rendered"].shape[0] for r in results)
    if counts["composite_forward"] != cams or counts["cumsum_1d"] != 2 * cams:
        fail(f"launch counts {counts} for {cams} rendered cameras")
    for i, res in enumerate(results):
        vals = [*res["psnr"], *res["ssim"], *res["pose_rot_err_deg"],
                *res["pose_transl_err_deg"]]
        if tuple(res["rendered"].shape) != (1, hw, hw, 3):
            fail(f"request {i}: rendered shape {tuple(res['rendered'].shape)}")
        if not bool(torch.isfinite(res["rendered"]).all()) or not all(
                map(lambda v: v == v and abs(v) != float("inf"), vals)):
            fail(f"request {i}: non-finite output")
        emit({"phase": "request", "index": i,
              "encoder_ms": res["times"]["encoder"]["mean_s"] * 1e3,
              "decoder_ms": res["times"]["decoder"]["mean_s"] * 1e3,
              "psnr": res["psnr"], "ssim": res["ssim"],
              "pose_rot_err_deg": res["pose_rot_err_deg"],
              "dropped_entries": res["dropped_entries"],
              "peak_bytes": res["peak_bytes"]})

    # The first request's render through the CPU path (plain versions of
    # K1 and K3) on the same Gaussians and pose.
    ex = requests[0]
    with torch.no_grad():
        c, t = ex["context"], ex["target"]
        out = encoder(c["image"][None], c["intrinsics"][None], t["image"][None],
                      t["intrinsics"][None])
        pose = out["extrinsics_cwt"][:, 2:]
        cams_args = (pose, t["intrinsics"][None], t["near"][None],
                     t["far"][None], (hw, hw), dec_cfg)
        gpu = decode_splatting(out["gaussians"], *cams_args)
        cpu = decode_splatting(out["gaussians"].map(lambda a: a.cpu()),
                               *[a.cpu() if torch.is_tensor(a) else a
                                 for a in cams_args])
    diff = (gpu.color.cpu() - cpu.color).abs()
    frac_ok = float((diff <= 3e-5).float().mean())
    if float(diff.max()) > 5e-3 or frac_ok < 0.999:
        fail(f"main-path render vs the CPU path: max {float(diff.max())}, "
             f"{frac_ok:.5f} within 3e-5")
    emit({"phase": "main_path", "requests": len(results), "launches": counts,
          "render_vs_cpu_path_max_abs_err": float(diff.max()),
          "render_vs_cpu_path_frac_within_3e-5": frac_ok,
          "warmup_psnr": warm["psnr"],
          "seconds_total": time.perf_counter() - t_start})

    # ---- 6. where the time goes ---------------------------------------
    # The decoder's stages apart, on the first request's Gaussians and
    # pose (with the render's 1/near rescale), timed with CUDA events.
    g0 = out["gaussians"].map(lambda a: a[0])
    scale = 1.0 / t["near"][0]
    cam = pose[0, 0].clone()
    cam[:3, 3] = cam[:3, 3] * scale
    pargs = (g0.means * scale, g0.covariances * scale**2, g0.harmonics,
             g0.opacities, cam, t["intrinsics"][0], (hw, hw))
    proj = project_gaussians(*pargs)
    bargs = (proj, (hw, hw), rcfg.max_tiles_per_gaussian, rcfg.chunk,
             entry_budget(rcfg, g0.means.shape[0]), rcfg.base_tiles_per_gaussian,
             rcfg.big_pool_factor, rcfg.depth_key)
    bins = bin_gaussians_prefix(*bargs)
    bg0 = torch.zeros(3, device=dev)
    stages = {
        "project_ms": time_ms(torch, lambda: project_gaussians(*pargs), 10),
        "bin_ms": time_ms(torch, lambda: bin_gaussians_prefix(*bargs), 10),
        "composite_ms": time_ms(
            torch, lambda: composite_prefix(proj, bins, (hw, hw), bg0), 10),
        "n_live": int(bins.n_live),
    }
    # The encoder's backbone apart from its heads (same request).
    images = torch.cat([c["image"], t["image"]])[None]
    images = (images - cfg.input_mean) / cfg.input_std
    intr = torch.cat([c["intrinsics"], t["intrinsics"]])[None]
    with torch.no_grad():
        stages["backbone_ms"] = time_ms(
            torch, lambda: encoder.backbone(images, intr, num_target=1), 5)
        stages["encoder_ms"] = time_ms(
            torch, lambda: encoder(c["image"][None], c["intrinsics"][None],
                                   t["image"][None], t["intrinsics"][None]), 5)
    emit({"phase": "breakdown", **stages})

    # ---- kernels line, card, result -----------------------------------
    emit({"kernels": [
        {"name": "composite_forward", "route": "cuda",
         "source": "spfsplatv2_tpu_torch/csrc/composite_forward.cu",
         "replaces": "spfsplatv2_tpu/ops/raster_pallas.py:185",
         "launches": counts["composite_forward"], **k1,
         "check": {"vs_plain_outlier_pixels": sum(
             v["outliers"] for v in k1_check.values()),
                   "vs_oracle_64px_max_abs_err": max(oracle.values())}},
        {"name": "cumsum_1d", "route": "cuda",
         "source": "spfsplatv2_tpu_torch/csrc/prefix_scan.cu",
         "replaces": "spfsplatv2_tpu/ops/segscan.py:108",
         "launches": counts["cumsum_1d"], **k3,
         "check": {"int32_exact": all(c["int32_exact"] for c in checks),
                   "f32_max_abs_err": max(c["f32_max_abs_err"]
                                          for c in checks)}},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
