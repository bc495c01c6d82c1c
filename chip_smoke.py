#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`spfsplatv2_tpu_torch`) on one NVIDIA GPU.

Run from the repository root, on a machine with a card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. environment: torch, the card, its power limit, the TF32 settings,
     whether `yaml` and `PIL` import and where `g++` is;
  2. build: every kernel (K1-K5, K5 in bf16 and float32), compiled from
     `csrc/` with one `nvcc` per source, all started together;
  3. K3 (`cumsum_1d`, csrc/prefix_scan.cu) against its plain version
     (int32 exact) at the main path's n, a ragged n and the 1024^2
     path's n, timed beside `torch.cumsum`: back-to-back calls (CUDA
     events) and the device time alone (torch.profiler's kernel records,
     which also count the kernels a call launches);
  4. K1 (`composite_forward`, csrc/composite_forward.cu) against its plain
     version on a pixel-aligned 131072-Gaussian scene at 256^2, binned by
     the port, and against the dense oracle on a 64^2 scene;
     "tiled_256": one render of that scene through the "tiled" backend
     (plain torch, no kernel) against "prefix" (K1, K3), both timed;
  5. the main path: the full-width `spfsplatv2` encoder (ViT-L 24x1024,
     decoders 2x12x768, DPT 256/128, SH degree 4, bf16 compute) from a
     seeded random init, serving 3 requests (2 context views + 1 target
     at 256^2) through `evaluate_example`, with the kernels' launch
     counts read around exactly those requests; the first request's
     render is held against the port's CPU path (the kernels' plain
     versions) on the same Gaussians.
  6. where the time goes: the decoder's stages and the encoder's backbone
     timed apart with CUDA events;
     "ortho_256": the first request's 131,072 Gaussians rendered by
     `models/decoder.py:decode_orthographic` at 256^2 from its first
     context view's camera, the view's world-space width and height the
     1st-99th percentile span of the means' x and y there: the render
     through K1 and K3 against their plain versions on the card, the
     render and a photometric loss's backward with respect to the means
     and the pose with the launch counts read around exactly them (K1 1,
     K3 2, K2 1), that K2 launch against its plain version, and the
     render's, the forward-plus-backward's and K1's and K2's ms beside
     the perspective render's of the same Gaussians from that camera;
  7. K2 (`composite_backward`, csrc/composite_backward.cu) against its
     plain version on phase 4's scene and bins with seeded cotangents, and
     its gradients against the dense oracle's autograd on the 64^2 scene;
  8. K4 (`segmented_scan_lanes`, csrc/segmented_scan.cu) on phase 7's rows
     in source order against its plain version, timed beside the
     `index_add_` that computes the same per-Gaussian sums, its device
     time and device operations a call from torch.profiler (one kernel,
     and the memset that zeroes its status words);
  9. test-time pose alignment: one request through `evaluate_example(...,
     align_pose=True)` at the published 100 steps and lr 5e-4, with K2's
     launches read around it;
 10. K5 (`flash_attention`: csrc/flash_forward.cu, flash_backward_dkv.cu,
     flash_backward_dq.cu) at the three shapes of the 1024^2 path
     (encoder (3, 16, 4096, 64), decoder view 0 (1, 12, 4098, 64), views
     1-2 (2, 12, 4098, 64)) with seeded inputs and cotangent: O, lse, dQ,
     dK and dV against their plain versions, the autograd function
     against autograd through the dense form; timed beside the plain
     versions and `torch.nn.functional.scaled_dot_product_attention`
     (the yardstick; the port never calls it), each kernel's TFLOP/s
     beside its bound; then "view_masked": the view-masked kernel
     (csrc/flash_view_masked.cu) at the decoders' cross-attention shapes
     of the flagship and v1 at 1024^2 against its plain version, timed
     beside its bound, the plain version, the dense path it replaces and
     SDPA with a boolean mask;
 11. the long-context serving path: 3 requests at 1024^2 (64 x 64
     patches a view, so every self-attention has 4096 or 4098 keys and
     takes K5) through `evaluate_example` with the quantized depth key,
     launch counts read around exactly those requests; then one encoder
     block's real q, k, v through K5 against the plain version, and, on
     the first request's 2 x 1024^2 Gaussians and pose, the render
     through K1 and K3 against the same render through their plain
     versions on the card, K3 on each of the binning's real inputs, and
     K2 on that camera's bins against its plain version; K1 and K2 timed
     on those bins beside their bounds; "ortho_1024": "ortho_256"'s
     checks on that request's 2 x 1024^2 Gaussians (the quantized depth
     key, which `decode_orthographic` keys relative to the nearest
     Gaussian), and the share of pixels within 1e-4 of the exact depth
     order's render (rank key) on 2^18 of them, under JAX's quantized key,
     the port's relative key (at least 99.9%) and, beside them, the
     perspective render's quantized key;
     "conv_probe": every float32 3x3 or 7x7 convolution of the flagship's
     DPT heads (`head_conv1` 256 -> 128 on the core's maps, `head_conv2`
     128 -> 128, the GS head's `input_merger` 3 -> 256 7x7 and
     `head_conv` 256 -> 256 at full resolution) alone through cuDNN and
     off it, at 1, 2 and 16 maps at 256^2 and 1 and 2 maps at 1024^2;
 12. the training path: 3 steps of `make_train_step` on the full-width
     encoder (remat on, seeded LPIPS, the re10k optimizer recipe) at the
     flagship batch, b = 16 of 2 context + 1 target at 256^2, with the
     launch counts read around exactly those steps; then one more step
     under the JAX package's `SPFSPLAT_ACCUM=segscan` switch, which
     reaches K4;
 13. the long-context training path: 2 steps at 1024^2, b = 2, with the
     launch counts (K5's backward kernels included) read around exactly
     those steps, and the (b, h, n_q, n_k) that their autograd gave K5's
     backward kernels; then K5's backward pair at each of those shapes
     (phase "K5_train"): the first batch element held against the plain
     versions, both kernels timed beside SDPA's backward;
     then the float32 long-context path, the same encoder with
     `CrocoBackboneConfig(compute_dtype="float32")` (the same seeded
     weights): "K5_f32", K5's float32 kernels, all on 3xTF32
     (csrc/flash_f32_forward.cu after the forward split pre-pass, the
     backward pair flash_f32_backward_dkv.cu, flash_f32_backward_dq.cu
     after the backward's; both passes in flash_f32_split.cu) at phase
     10's three shapes on seeded float32 inputs, O and lse within 2e-5 and
     dQ, dK, dV within 1e-4 of max against their plain versions, the
     splits bit for bit, each kernel launched twice with identical bits,
     the autograd function against the dense form, timed beside their
     plain versions and SDPA in float32 with their TFLOP/s beside their
     bounds (3 x their FLOPs at the TF32 rate, the FP32 bound printed
     beside it);
     "serving_1024_f32", 3 requests at 1024^2 through `evaluate_example`
     (48 float32 forward launches each, no bf16 K5 launch), encoder block
     12's real q, k, v through the float32 kernel against the plain
     version and the first request's render through K1 and K3 against
     their plain versions on the card; "train_1024_f32", 2 steps at b = 2
     with the microbatch `training/loop.py:fit_microbatch` picks (its
     probes' peaks recorded), launch counts read around exactly those
     steps, their first K2 launch held against its plain version; then
     "K5_f32_train", the float32 backward pair (and its split) at the
     shapes those steps gave it, two launches bit-identical, and the
     forward (and its split) at the same shapes beside SDPA's forward;
     "demo_1024", the demo (`spfsplatv2_tpu_torch.demo.run_demo`) in
     process on two seeded 1152 x 1536 photos at --image-size 1024 from a
     seeded init of the flagship (bf16): launch counts read around
     exactly that call (96 bf16 K5 forward, 60 K1, 120 K3, no other),
     the poses, the PLY read back (2 x 1024^2 vertices), the GIF's 118
     frames of 1024^2, the first frame's render against the plain
     versions of K1 and K3 on the card, and the encoder passes', the
     60-frame render's, the PLY's and the GIF's times and the peak
     memory;
 14. the command line, `spfsplatv2_tpu_torch.main.main([...])` in process
     with `--config experiments/spfsplatv2/re10k.yaml` and overrides only
     (phases "cli_*"): synthetic train, val and test chunks written under
     `build/cli/` ("cli_data"); 3 training steps at the published widths,
     b = 16 at 256^2, the memory guard choosing the microbatch, one
     validation, the final checkpoint ("cli_train": step times, data
     waits, the guard's probes, K1-K3 launches against the count the
     steps, probes and validation render, the checkpoint's seconds and
     bytes, the validation's interpolation and wobble GIFs of 58 frames,
     and no "validation video skipped" line); the guard alone under a
     budget below the step's peak, which must halve the microbatch and
     take no step ("cli_guard"); mode=test from that checkpoint with
     images and videos saved and seeded LPIPS, the five artifact files,
     the first saved PNG read back against its frame, each scene's GIF of
     its target frames ("cli_test"); mode=eval_pose with the native PnP library built by
     g++ ("cli_eval_pose");
 19. the VGGT-1B family at full width: the encoder of
     experiments/spfsplatv2-l/re10k.yaml (DINOv2 24x1024, 24 frame and
     24 global blocks, camera head, point and GS heads: 1,190,626,953
     parameters, bf16 aggregator) from a seeded random init (points and
     cameras placed in front of each other, `place_vggt_scene`), serving 3
     requests (2 context views + 1 target at 224^2) through
     `evaluate_example`, launch counts read around exactly those
     requests; the first request's render through K1 and K3 held against
     their plain versions on the card ("vggt_serve");
 20. 2 train steps of `make_train_step` at the preset's b = 10 with the
     microbatch `training/loop.py:fit_microbatch` picks (its probes'
     peaks recorded), launch counts read around exactly those steps, the
     steps' first K2 launch held against its plain version on the same
     inputs and bins ("vggt_train");
 21. the command line on that preset: mode=train for 2 steps on phase
     14's chunks (the memory guard, one validation, the 14 GB
     checkpoint's seconds and bytes), then mode=test from that checkpoint
     ("vggt_cli");
 22. SPFSplat v1 at full width: the encoder of experiments/spfsplat/
     re10k.yaml (ViT-L 24x1024 shared across views with the intrinsics
     token at its input, 2 x 12 x 768 decoders run over the context views
     and again over all views, four DPT heads, pose heads on pooled
     1792-d tokens; bf16 compute) from a seeded init, serving 3 requests
     (2 context views + 1 target at 256^2) through `evaluate_example`,
     launch counts read around exactly those requests, the first
     request's render through K1 and K3 held against their plain versions
     on the card ("v1_request"); then one request at 1024^2, whose 72 K5
     forwards and 48 view-masked launches write no dense logits
     ("v1_request_1024");
 23. 2 train steps of `make_train_step` at the preset's b = 12 with the
     microbatch `training/loop.py:fit_microbatch` picks, launch counts
     read around exactly those steps, `loss/reproj_c2_only` in each, the
     first K2 launch held against its plain version ("v1_train");
 24. 2 more steps with the full-width DUSt3R teacher, loaded through
     `training/loop.py:load_distiller_params` from a seeded random state
     dict with DUSt3R's key names and shapes written to a file:
     `loss/distillation` finite and above 0, the teacher bit for bit
     unchanged and without gradients ("v1_distill");
 25. the command line on that preset: mode=train for 2 steps on phase
     14's chunks from a seeded random MASt3R-keyed state dict
     (`checkpointing.pretrained_weights`), one validation, the final
     checkpoint, then mode=test from it ("v1_cli"); then `build/cli/` is
     deleted;
 26. the 10-view VGGT preset (experiments/spfsplatv2-l/re10k_10view.yaml)
     at full width: one request of 10 context views and a target at
     224^2 and one train step at its b = 2 with its context-view dropout
     and the guard's microbatch, launch counts read around each
     ("vggt_10view"), and `utils/drawing.py:draw_cameras` of that
     request's 11 predicted poses on the card against the CPU;
 27. "utils": a fresh seeded flagship (bf16) serves one 256^2 request
     inside `utils/profiling.py:trace` (the Chrome trace's bytes and
     device events), and `utils/logger.py:LocalLogger` writes a record
     and the drawn cameras' PNG;
 28. "tile_shard_1024": that encoder's pass on a 1024^2 request (48 K5
     forward and 24 view-masked launches) gives 2 x 1024^2 Gaussians; their render and its
     backward here, then `parallel/raster_shard.py:render_tile_sharded`
     by two gloo ranks sharing the card (torch.multiprocessing.spawn),
     each a 512-row band (K1 and K3 in each, K2 in each backward): the
     gathered image against the single render within
     tests/test_tile_shard.py's bounds, the summed Gaussian gradients
     against the single render's, the ranks' gradients bit-identical;
 29. "ddp_2rank": the b = 16 flagship step (the re10k recipe, seeded
     LPIPS) here, then by two gloo ranks of b = 8 on the card through
     `make_train_step(mesh=make_mesh(n_data=2))`: the loss and the
     all-reduced gradient against this process's, the replicas bit for
     bit, K1-K3 launches a rank, the all-reduce audit (count, bytes
     against the trainable float32 bytes) and, on a second profiled
     step, whether a bucket's all-reduce started before the backward
     ended (recorded, not gated);
 30. "cli_ddp": `python -m torch.distributed.run --standalone
     --nproc_per_node=2 -m spfsplatv2_tpu_torch.main` on the DL3DV
     preset for 3 steps of b = 8 a rank (gloo: the ranks share the
     card), on chunks that `data/convert_dl3dv.py` writes from seeded
     nerfstudio-layout scenes of 270 x 480 frames; each rank's scenes
     (disjoint), the step lines and the checkpoint's bytes; then
     mode=test in this process from rank 0's checkpoint;
 31. "overfit_short": `spfsplatv2_tpu_torch.overfit`, the flagship
     overfit recipe (full width, seeded init, one synthetic 256^2 scene,
     b = 2), for 100 steps with a curve point every 10, its train step
     wrapped to read the launch counts around each step: every loss and
     PSNR finite, skipped steps under 5% of the steps + 10, the mean loss
     of the last 20 steps below that of the first 20, K1 2, K3 4 and K2 2
     launches in each step; the curve and the steps a second printed, and
     step 50 under torch.profiler (its device busy share, costliest
     kernels).
Then the script's seconds so far (phase "done"), the kernels line (each
kernel's times, bound, launches on its path and check results), the
card's name and power limit, and the result.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12      # FP32 outside the tensor cores, same source
H100_BF16_PER_S = 989e12     # bf16 tensor cores, dense, same source
H100_TF32_PER_S = 495e12     # TF32 tensor cores, dense, same source
# K5's float32 kernels run each product as three TF32 products (lo*hi +
# hi*lo + hi*hi): their bound is 3 x their FLOPs at the TF32 rate.
K5_TF32_PASSES = 3
# FP32 operations per (pixel, entry) pair in K1: an evaluated pair pays
# dx, dy and the power (11), exp, scale and clamp (3); a blended pair adds
# the transmittance test (2), its weight (1) and 4 accumulations (8).
K1_OPS_WALKED, K1_OPS_BLENDED = 14, 11
# K2: an evaluated pair pays what it pays in K1 (14); a blended pair adds
# the transmittance test (2), its weight (1), u (7), the suffix update (2),
# dL/dalpha (5), dpow (1), the ten fields (23) and their ten sums over
# the tile's pixels (10).
K2_OPS_WALKED, K2_OPS_BLENDED = 14, 51
# The operation bound counts only the blended pairs, each at both rates
# added: a pair that is not blended contributes nothing, and a kernel
# that culls need not evaluate it.  The walked pairs' count (every entry
# of a pixel up to the one that stops it) stays in the phase lines as
# "ops_walked", the bound of the kernels that walked every pair.
# Full batch of the flagship recipe fits on the 80 GB card in one pass
# (peak memory in PERF.md), so the step takes no gradient accumulation.
TRAIN_BATCH, TRAIN_MICROBATCH = 16, 16
ALIGN_STEPS, ALIGN_LR = 100, 5e-4
# The long-context path: 1024^2 views, b = 2 in training (microbatch in
# PERF.md), K5 at these (b, h, n_q, n_k) with head dim 64.
HW_LONG = 1024
LONG_BATCH, LONG_MICROBATCH = 2, 2
K5_SHAPES = {"encoder": (3, 16, 4096, 4096),
             "decoder_view0": (1, 12, 4098, 4098),
             "decoder_views12": (2, 12, 4098, 4098)}
# Kernel against plain version, as fractions of max |plain|: (O, lse, dQ
# / dK / dV, the autograd function against autograd through the float32
# dense form).  bf16: the kernels round P and dS to bf16.  float32:
# nothing is rounded, only the order of float32 sums differs.
K5_TOLS = {"bfloat16": (1e-2, 1e-4, 1e-2, 2e-2),
           "float32": (2e-5, 2e-5, 1e-4, 1e-4)}
K5_FLOPS = {"forward": 4, "backward_dkv": 8,
            "backward_dq": 6}  # x b*h*n_q*n_k*64
# The forward's other bound: one ex2 per logit on the special-function
# units, 16 a clock on each of the 132 SMs at 1.83 GHz (the FlashAttention-3
# paper's 3.9 T/s for the H100 SXM).
H100_EX2_PER_S = 3.9e12
# K3's calls for its profiler window (device time per call and kernels
# per call).
K3_PROFILE_CALLS = 50
# Self-attention launches per 1024^2 encoder pass: 24 encoder blocks and
# 12 + 12 decoder blocks; the 12th call (encoder block 12) is held
# against the plain version on its real q, k, v.
K5_PER_PASS, K5_CHECK_CALL = 48, 11
# The view-masked kernel (csrc/flash_view_masked.cu, phase "view_masked")
# at the decoders' cross-attention shapes: (views, num_target, query
# views [lo, hi), tokens a view), 12 heads.  The flagship at 1024^2 (2 + 1
# views of 4,098 tokens: view 0, views 1-2) and v1 (4,097: the context
# pass's view 0; the all-views pass's view 0 and views 1-2).  Launches:
# 12 + 12 a flagship 1024^2 encoder pass; v1's two passes, 48 a request,
# beside its 72 K5 forwards.
VIEW_MASKED_SHAPES = {"v2_view0": (3, 1, (0, 1), 4098),
                      "v2_views12": (3, 1, (1, 3), 4098),
                      "v1_context_view0": (2, 0, (0, 1), 4097),
                      "v1_all_view0": (3, 0, (0, 1), 4097),
                      "v1_all_views12": (3, 0, (1, 3), 4097)}
VIEW_MASKED_PER_PASS = 24
V1_1024_K5, V1_1024_VIEW_MASKED = 72, 48
# Gaussians of the 1024^2 request whose orthographic render is held
# against the exact depth order: 18 rank bits + 13 tile bits = 31.
ORTHO_ORDER_SAMPLE = 1 << 18
# The command line (phases "cli_*"): the flagship preset with overrides
# only.  Synthetic chunks at the preset's original_image_shape: 8 train
# scenes (a batch of 16 holds each twice; writing the frames is most of
# the phase's time), 26 frames each (the preset's curriculum starts at a
# 25-frame context gap), one val scene and two test scenes read through
# an evaluation index.
CLI_PRESET = "experiments/spfsplatv2/re10k.yaml"
CLI_SCENES = {"train": (8, 26), "val": (1, 26), "test": (2, 8)}
CLI_INDEX = {"scene_000": {"context": [0, 7], "target": [3, 4], "overlap": 0.3},
             "scene_001": {"context": [1, 6], "target": [4], "overlap": 0.6}}
CLI_STEPS, CLI_VAL_EVERY = 3, 2
# Below phase 12's 33.8 GB peak at b = 16: the guard must halve.
CLI_LOW_BUDGET_GB = 24.0
# The VGGT-1B family (phases "vggt_*"): the encoder of this preset at full
# width on seeded random weights, 2 context views + 1 target at its 224^2,
# training at its batch of 10 with the microbatch the memory guard picks.
VGGT_PRESET = "experiments/spfsplatv2-l/re10k.yaml"
VGGT_PARAMS = 1_190_626_953
VGGT_REQUESTS, VGGT_STEPS, VGGT_CLI_STEPS = 3, 2, 2
# The flagship at 1024^2 with compute_dtype="float32" (phases "K5_f32",
# "serving_1024_f32", "train_1024_f32"): requests served; training at
# LONG_BATCH with the microbatch the memory guard picks.
F32_REQUESTS = 3
# The float32 convolutions of 3x3 or wider in the DPT heads, for
# "conv_probe": name -> (in, out, kernel side, {image side: map side}).
# The VGGT heads' `output_conv1` at 224^2 (a request's and a microbatch's
# context views: 1, 2 and 10 maps); the flagship heads' at 256^2 (a
# request gives each head 1 map, the b = 16 step 16) and 1024^2.
VGGT_CONVS = {"output_conv1": (256, 128, 3, {224: 128})}
FLAGSHIP_CONVS = {
    "DPTHead.head_conv1": (256, 128, 3, {256: 128, 1024: 512}),
    "DPTHead.head_conv2": (128, 128, 3, {256: 256, 1024: 1024}),
    "DPTGSHead.input_merger": (3, 256, 7, {256: 256, 1024: 1024}),
    "DPTGSHead.head_conv": (256, 256, 3, {256: 256, 1024: 1024}),
}
FLAGSHIP_CONV_MAPS = {256: (1, 2, 16), 1024: (1, 2)}
# The validation step's two context videos (interpolation and wobble),
# 30 frames rendered each, written there and back (30 + 28 frames).
VAL_VIDEO_FRAMES = 30
# The demo (phase "demo_1024"): two seeded 1152 x 1536 photos (h x w,
# so the centre crop and the resize both run) at --image-size 1024, no
# checkpoint, the flagship's SPFSplatV2Config(); its 60-frame
# interpolation video is written there and back (60 + 58 frames).
DEMO_PHOTO_HW, DEMO_SIZE, DEMO_FRAMES = (1152, 1536), 1024, 60
# The seeded init's pose heads start at the identity (as JAX's), so both
# views get the same pose and the video one still frame, which the GIF
# writer merges; view 1's pose head gets this translation bias.
DEMO_BASELINE = 0.3
PLY_FLOATS = 17  # xyz, normals, DC colour, opacity, 3 scales, 4 rotation
# SPFSplat v1 (phases "v1_*"): the encoder of this preset at full width on
# seeded random weights, 2 context views + 1 target at its 256^2, training
# at its batch of 12 with the microbatch the memory guard picks; the
# DUSt3R teacher and the pretrained weights from seeded random state dicts
# with DUSt3R's and MASt3R's key names and shapes, written to files.
V1_PRESET = "experiments/spfsplat/re10k.yaml"
V1_REQUESTS, V1_STEPS, V1_DISTILL_STEPS, V1_CLI_STEPS = 3, 2, 2, 2
# The 10-view VGGT preset (phase "vggt_10view"): one request and one step
# at its b = 2, 10 context views and one target, with its view dropout.
VGGT_10VIEW_PRESET = "experiments/spfsplatv2-l/re10k_10view.yaml"
# Data parallelism (phases "ddp_2rank", "tile_shard_1024", "cli_ddp"):
# two gloo ranks on the one card.  "ddp_2rank": the flagship step at
# TRAIN_BATCH in this process, then TRAIN_BATCH // 2 a rank; the loss
# within DDP_LOSS_RTOL, the all-reduced gradient within DDP_GRAD_BAR of
# max |g| (bf16 compute: the b = 8 and b = 16 passes may take GEMM kernels
# that round differently, 2^-8 of each bf16 product, and the gradient sums
# millions of them), the all-reduce's bytes within DDP_AUDIT_RATIO of the
# trainable float32 bytes (the JAX package's audit bounds).
DDP_WORLD, FLAGSHIP_HW = 2, 256
DDP_LOSS_RTOL, DDP_GRAD_BAR = 1e-3, 5e-2
DDP_AUDIT_RATIO = (0.9, 3.0)
# "tile_shard_1024": the bands against the single render, with
# tests/test_tile_shard.py's bounds (atol, share within it, hard bound);
# each Gaussian field's summed gradient within TILE_GRAD_TOL of its max
# in TILE_GRAD_SHARE of the Gaussians (a band's camera rounds a pixel
# coordinate differently from the full camera's, and a Gaussian that
# crosses the bands' border fills its tile slots in another order, which
# can reorder its ties in the quantized depth key).  A band gradient
# summed over the ranks would come back twice as large: no Gaussian
# within the bar.
TILE_BOUNDS = {"color": (1e-4, 0.999, 5e-3), "alpha": (1e-4, 0.999, 5e-3),
               "depth": (1e-3, 0.999, 2e-2)}
TILE_GRAD_TOL, TILE_GRAD_SHARE = 1e-4, 0.999
# "cli_ddp": `torchrun` over two ranks on the DL3DV preset, on chunks that
# the port's converter writes from seeded nerfstudio-layout scenes of
# 270 x 480 frames: CLI_DDP_SCENES train scenes (more than the ranks'
# CLI_DDP_STEPS batches of CLI_DDP_BATCH read in one epoch, so that the
# ranks' scenes stay disjoint), CLI_DDP_FRAMES frames each (the preset's
# bounded sampler starts at a 5-7 frame context gap).
DL3DV_PRESET = "experiments/spfsplatv2/dl3dv.yaml"
CLI_DDP_SCENES, CLI_DDP_FRAMES, CLI_DDP_STEPS, CLI_DDP_BATCH = 56, 12, 3, 8
CLI_DDP_INDEX = {"test_000": {"context": [0, 6], "target": [3], "overlap": 0.4},
                 "test_001": {"context": [2, 8], "target": [4, 5],
                              "overlap": 0.5}}
# "overfit_short": `spfsplatv2_tpu_torch.overfit`'s recipe (the flagship
# at full width from a seeded init on one synthetic 256^2 scene, b = 2)
# for OVERFIT_STEPS steps, a curve point every OVERFIT_LOG_EVERY.  It
# gates only what noise cannot break: finite losses, skipped steps under
# 5% of the steps + 10 (a collapse skips every step), the mean loss of the
# last OVERFIT_WINDOW steps below that of the first, and each step's
# launches: one target a sample, so K1 and K2 twice and K3 four times.
# Step OVERFIT_PROFILE_STEP runs under torch.profiler: the step's device
# busy share and its costliest kernels (recorded, not gated).
OVERFIT_STEPS, OVERFIT_LOG_EVERY, OVERFIT_WINDOW = 100, 10, 20
OVERFIT_PROFILE_STEP = 50
OVERFIT_STEP_LAUNCHES = {"composite_forward": 2, "cumsum_1d": 4,
                         "composite_backward": 2}
FLAGSHIP_PARAMS = 608_017_854


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def run_cli(cli, argv: list) -> int:
    """`cli.main(argv)` in process, its standard output passed through;
    fails if the validation step reports a skipped video (the loop goes
    on without it, so the check is here)."""
    out, kept = sys.stdout, io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, text):
            kept.write(text)
            return out.write(text)

        def flush(self):
            out.flush()

    with contextlib.redirect_stdout(Tee()):
        rc = cli.main(argv)
    skipped = [line for line in kept.getvalue().splitlines()
               if "validation video skipped" in line]
    if skipped:
        fail(f"{' '.join(argv[-3:])}: {skipped}")
    return rc


def gif_frames(path: Path) -> tuple:
    """(frames, (width, height)) of a GIF.  The GIF writer merges a frame
    identical to the one before it into that one: a video of a model
    that has barely trained (its poses near the identity, where its pose
    heads start) holds fewer frames than it rendered, so the phases of
    such models check the frames rendered by the launch counts."""
    from PIL import Image

    with Image.open(path) as gif:
        return gif.n_frames, gif.size


class Timer:
    """Host-clock spans around work that ends in a synchronize, by name."""

    def __init__(self, torch, dev):
        self.torch, self.dev, self.spans = torch, dev, {}

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            self.torch.cuda.synchronize(self.dev)
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize(self.dev)
            self.spans.setdefault(name, []).append(time.perf_counter() - t)
            return out

        return timed


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


def profile_calls(torch, fn, calls: int) -> tuple:
    """Device time per call of `fn` from torch.profiler's records of the
    device's kernels and memsets over `calls` calls, and those records per
    call by name.  The profiler runs one warm-up step (one call) whose
    records it discards: a window opened cold can miss the first call's
    device records (one of 50 calls' memsets, at times its kernel)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    kept = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.extend(p.events())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    # The step's own marker ("ProfilerStep#1") lies on the device's
    # timeline too.
    ops = [e for e in kept
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("ProfilerStep")]
    if not ops:
        fail("torch.profiler recorded no device time")
    names: dict[str, int] = {}
    for e in ops:
        names[e.name[:80]] = names.get(e.name[:80], 0) + 1
    return (sum(e.device_time_total for e in ops) / 1e3 / calls,
            {name: count / calls for name, count in names.items()})


def replayed_kernels(torch, fn, names: tuple) -> dict:
    """Device launches of each kernel in `names` (a part of its name) in
    one call of `fn`, from torch.profiler's trace: a CUDA graph's replay
    calls no kernel wrapper, so only the trace sees the kernels it runs."""
    _, per_call = profile_calls(torch, fn, 1)
    return {n: sum(c for op, c in per_call.items() if n in op) for n in names}


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


def max_err(actual, desired) -> dict:
    actual, desired = actual.detach().float(), desired.detach().float()
    diff = (actual - desired).abs()
    return {"max_abs_err": float(diff.max()), "mean_abs_err": float(diff.mean()),
            "ref_max_abs": float(desired.abs().max())}


@contextlib.contextmanager
def plain_dispatch(raster_tiled, raster_cuda, cumsum_1d_plain, scans: list):
    """Route the rasterizer's K1 and K3 dispatchers to their plain versions
    on the card's tensors, recording each prefix sum's input in `scans`."""
    def scan(x):
        scans.append(x)
        return cumsum_1d_plain(x)

    saved = raster_tiled.cumsum_1d, raster_cuda.composite_forward
    raster_tiled.cumsum_1d = scan
    raster_cuda.composite_forward = raster_cuda.composite_forward_plain
    try:
        yield
    finally:
        raster_tiled.cumsum_1d, raster_cuda.composite_forward = saved


def check_k2_rows(accumulate_rows, rows_k, rows_p, bins, g: int,
                  where: str) -> dict:
    """K2's rows against its plain version's: at most 1e-3 of the live rows
    off by more than 1e-4 of their field's max, nothing written past
    n_live, and the per-Gaussian sums within 2e-3 of their field's max."""
    n_live = int(bins.n_live)
    diff = (rows_k - rows_p).abs()
    bad_rows = int((diff > 1e-4 * rows_p.abs().amax(0)).any(-1).sum())
    if bad_rows > 1e-3 * n_live:
        fail(f"K2 rows vs plain ({where}): {bad_rows} of {n_live} rows over "
             "1e-4 x max")
    if float(rows_k[n_live:].abs().max()) != 0.0:
        fail(f"K2 wrote past n_live ({where})")
    per_g_k = accumulate_rows(rows_k, bins, g)
    per_g_p = accumulate_rows(rows_p, bins, g)
    per_g_err = (per_g_k - per_g_p).abs()
    if bool((per_g_err > 2e-3 * per_g_p.abs().amax(0)).any()):
        fail(f"K2 per-Gaussian sums vs plain ({where}): max "
             f"{float(per_g_err.max())}")
    return {"n_live": n_live, "rows_over_1e-4_of_max": bad_rows,
            "rows_max_abs_err": float(diff.max()),
            "per_gaussian_max_abs_err": float(per_g_err.max())}


def composite_bound(bins, walked: int, blended: int, out_numel: int,
                    backward: bool) -> dict:
    """K1's (or K2's) least time on these bins: the bytes it must move
    (each live entry's index, each live Gaussian's 40-byte row, the
    tiles' counts and starts, the output; K2 also reads the cotangent and
    writes a 40-byte row a slot) against the operations of the blended
    pairs."""
    n_live = int(bins.n_live)
    n_tiles = bins.counts.shape[0]
    live_rows = int((bins.live_counts > 0).sum())
    n_bytes = n_live * 4 + live_rows * 40 + 2 * n_tiles * 4 + out_numel * 4
    walked_rate, blended_rate = ((K2_OPS_WALKED, K2_OPS_BLENDED) if backward
                                 else (K1_OPS_WALKED, K1_OPS_BLENDED))
    if backward:
        n_bytes += out_numel * 4 + bins.e_pad * 40
    ops = blended * (walked_rate + blended_rate)
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_PER_S * 1e3
    return {"bound_bytes": n_bytes, "bound_ops": ops,
            "ops_walked": walked * walked_rate + blended * blended_rate,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def evaluated_pairs(torch, cull_box_plain, packed, bins) -> int:
    """The (pixel, entry) pairs that K1 and K2 evaluate on these bins: each
    8 x 4 pixel rectangle of a tile (a warp) walks the entries whose cull
    box meets it, by the kernels' predicate in PyTorch (`cull_box_plain`,
    which may differ from the card's by a pixel where float32 rounding
    puts a box edge on an integer)."""
    counts = bins.counts.long()
    dev = counts.device
    tile = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev),
                                   counts)
    first = torch.cumsum(counts, 0) - counts
    slot = bins.starts.long()[tile] + torch.arange(tile.shape[0],
                                                   device=dev) - first[tile]
    rows = packed[bins.src.long()[slot]]
    tiles_x = bins.num_tiles_xy[1]
    x_lo, x_hi, y_lo, y_hi = cull_box_plain(
        rows[:, 0] - ((tile % tiles_x) * 16).float(),
        rows[:, 1] - ((tile // tiles_x) * 16).float(),
        rows[:, 2], rows[:, 3], rows[:, 4], rows[:, 8])
    hits = 0
    for x0 in (0, 8):
        for y0 in (0, 4, 8, 12):
            hits += int(((x_lo <= x0 + 7) & (x_hi >= x0) & (y_lo <= y0 + 3)
                         & (y_hi >= y0)).sum())
    return 32 * hits


def k5_kernels(attention, dtype) -> dict:
    """K5's kernel names for `dtype`, by role ("forward", "backward_dkv",
    "backward_dq")."""
    return dict(zip(K5_FLOPS, attention.FLASH_KERNELS[dtype]))


def k5_bound_ms(torch, role: str, shape: tuple, dtype) -> float:
    """A K5 kernel's least time at (b, h, n_q, n_k), by kernel: its FLOPs
    on the bf16 tensor cores; for float32, three times over at the TF32
    rate."""
    b, h, n_q, n_k = shape
    flops = K5_FLOPS[role] * b * h * n_q * n_k * 64
    if dtype == torch.bfloat16:
        return flops / H100_BF16_PER_S * 1e3
    return K5_TF32_PASSES * flops / H100_TF32_PER_S * 1e3


def k5_fma_bound_ms(role: str, shape: tuple) -> float:
    """The same FLOPs on the FP32 units (67 TFLOP/s): the float32 kernels'
    bound before their products moved to the tensor cores."""
    b, h, n_q, n_k = shape
    return K5_FLOPS[role] * b * h * n_q * n_k * 64 / H100_FP32_PER_S * 1e3


def split_bytes(shape: tuple) -> int:
    """The backward's split pre-pass's bytes: q, k, v, dO read once; their
    hi and lo planes as they lie (8) and those of q, k, dO transposed, n
    padded to a multiple of 8 (6), written once."""
    b, h, n_q, n_k = shape
    n8_q, n8_k = -(-n_q // 8) * 8, -(-n_k // 8) * 8
    rows = 2 * (n_q + n_k) * 3 + 2 * (2 * n8_q + n8_k)
    return b * h * 64 * 4 * rows


def split_forward_bytes(shape: tuple) -> int:
    """The forward's split pre-pass's bytes: k and v read once, k's hi and
    lo planes and v's transposed ones (n padded to a multiple of 8)
    written once."""
    b, h, _, n_k = shape
    return b * h * 64 * 4 * (2 * n_k + 2 * n_k + 2 * (-(-n_k // 8) * 8))


def f32_split_check(torch, attention, q, k, v, do, where: str) -> dict:
    """The split pre-passes twice on the same inputs against their plain
    versions (the backward's on q, k, v, dO; the forward's on k, v): all
    bit-identical, or fail.  Returns the backward's planes."""
    planes = []
    for fn, plain_fn, args in (
            (attention.flash_f32_split_cuda, attention.flash_f32_split_plain,
             (q, k, v, do)),
            (attention.flash_f32_split_forward_cuda,
             attention.flash_f32_split_forward_plain, (k, v))):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        for name, want in plain_fn(*args).items():
            if not (torch.equal(first[name], want)
                    and torch.equal(second[name], want)):
                fail(f"K5 float32 split {where} {name}: not bit-identical to "
                     "its plain version in two launches")
        planes.append(first)
    return planes[0]


def forward_twice(torch, attention, q, k, v, scale, where: str) -> tuple:
    """The float32 forward (with its split pre-pass) launched twice on the
    same inputs; fail unless the two give identical bits.  Returns (o,
    lse)."""
    runs = [attention.flash_forward_cuda(q, k, v, scale) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b_ in zip(("o", "lse"), *runs):
        if not torch.equal(a, b_):
            fail(f"K5 float32 {where}: two launches of the forward differ "
                 f"in {name}")
    return runs[0]


def pair_twice(torch, attention, args, split, where: str) -> tuple:
    """The float32 backward pair launched twice on the same inputs; fail
    unless the two give identical bits.  Returns (dk, dv, dq)."""
    runs = [(*attention.flash_backward_dkv_cuda(*args, split=split),
             attention.flash_backward_dq_cuda(*args, split=split))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dk", "dv", "dq"), *runs):
        if not torch.equal(a, b_):
            fail(f"K5 float32 {where}: two launches of the {name} kernel "
                 "differ")
    return runs[0]


def k5_inputs(torch, attention, shape: tuple, gen, dev, dtype) -> tuple:
    """Seeded N(0, 1) q, k, v and cotangent dO of `dtype` at (b, h, n_q,
    n_k) with head dim 64, K5's forward O and lse on them, and di =
    rowsum(dO * O) as the autograd function computes it."""
    b, h, n_q, n_k = shape

    def make(n):
        return torch.randn(b, h, n, 64, generator=gen, device=dev).to(dtype)

    q, k, v, do = make(n_q), make(n_k), make(n_k), make(n_q)
    if dtype == torch.float32:
        o, lse = forward_twice(torch, attention, q, k, v, 64**-0.5,
                               f"shape {shape}")
    else:
        o, lse = attention.flash_forward_cuda(q, k, v, 64**-0.5)
    return q, k, v, do, o, lse, (do.float() * o.float()).sum(-1)


def k5_phase(torch, attention, name: str, shape: tuple, gen, dev,
             dtype) -> dict:
    """K5's three kernels of `dtype` against their plain versions, and the
    autograd function against autograd through the float32 dense form,
    at one path shape with seeded inputs and cotangent (float32: the
    split pre-pass bit for bit against its plain version, and each new
    kernel launched twice with identical bits); then their times beside
    the plain versions and SDPA's in the same dtype."""
    import torch.nn.functional as F

    b, h, n_q, n_k = shape
    scale = 64**-0.5
    o_tol, lse_tol, grad_tol, dense_tol = K5_TOLS[str(dtype).removeprefix("torch.")]
    names = k5_kernels(attention, dtype)
    q, k, v, do, o, lse, di = k5_inputs(torch, attention, shape, gen, dev,
                                        dtype)
    split = None
    if dtype == torch.float32:
        split = f32_split_check(torch, attention, q, k, v, do, name)
        dk, dv, dq = pair_twice(torch, attention,
                                (q, k, v, do, lse, di, scale), split, name)
    else:
        dk, dv = attention.flash_backward_dkv_cuda(q, k, v, do, lse, di,
                                                   scale)
        dq = attention.flash_backward_dq_cuda(q, k, v, do, lse, di, scale)
    torch.cuda.synchronize()
    o_p, lse_p = attention.flash_forward_plain(q, k, v, scale)
    dk_p, dv_p = attention.flash_backward_dkv_plain(q, k, v, do, lse, di, scale)
    dq_p = attention.flash_backward_dq_plain(q, k, v, do, lse, di, scale)
    checks = {"o": max_err(o, o_p), "lse": max_err(lse, lse_p),
              "dq": max_err(dq, dq_p), "dk": max_err(dk, dk_p),
              "dv": max_err(dv, dv_p)}
    del o_p, lse_p, dk_p, dv_p, dq_p
    for key, c in checks.items():
        tol = {"o": o_tol, "lse": lse_tol}.get(key, grad_tol)
        if not c["max_abs_err"] <= tol * c["ref_max_abs"]:
            fail(f"K5 {dtype} {name} {key} vs plain: {c} (bar {tol} x max)")

    def grads(fn, leaf_dtype):
        leaves = [t.to(leaf_dtype).requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, scale)
        return out, torch.autograd.grad(out, leaves, do.to(leaf_dtype))

    out_k, g_k = grads(attention.flash_attention, dtype)
    out_d, g_d = grads(attention._dense, torch.float32)
    dense = {key: max_err(a, ref) for key, a, ref in
             zip(("o", "dq", "dk", "dv"), (out_k, *g_k), (out_d, *g_d))}
    for key, c in dense.items():
        if not c["max_abs_err"] <= dense_tol * c["ref_max_abs"]:
            fail(f"K5 {dtype} {name} autograd {key} vs the float32 dense "
                 f"form: {c}")
    del out_k, g_k, out_d, g_d

    bwd_args = (q, k, v, do, lse, di, scale)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(*leaves, scale), leaves, do)

    sdpa = lambda q_, k_, v_, s: F.scaled_dot_product_attention(  # noqa: E731
        q_, k_, v_, scale=s)
    sdpa_out = sdpa(*leaves, scale)
    iters = 20 if dtype == torch.bfloat16 else 5
    times = {
        "forward": {
            "ms": time_ms(torch, lambda: attention.flash_forward_cuda(
                q, k, v, scale), iters),
            "plain_ms": time_ms(torch, lambda: attention.flash_forward_plain(
                q, k, v, scale), 3, warmup=1),
            "library_ms": time_ms(torch, lambda: sdpa(q, k, v, scale), iters)},
        "backward_dkv": {
            "ms": time_ms(torch, lambda: attention.flash_backward_dkv_cuda(
                *bwd_args, split=split), iters // 2),
            "plain_ms": time_ms(torch, lambda: attention.
                                flash_backward_dkv_plain(*bwd_args), 3,
                                warmup=1)},
        "backward_dq": {
            "ms": time_ms(torch, lambda: attention.flash_backward_dq_cuda(
                *bwd_args, split=split), iters // 2),
            "plain_ms": time_ms(torch, lambda: attention.
                                flash_backward_dq_plain(*bwd_args), 3,
                                warmup=1)},
    }
    # SDPA's backward gives dQ, dK and dV in one call: it stands beside
    # both backward kernels.
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, leaves, do, retain_graph=True), iters // 2)
    for role in ("backward_dkv", "backward_dq"):
        times[role]["library_ms"] = sdpa_bwd
    for role, t in times.items():
        t["bound_ms"] = k5_bound_ms(torch, role, shape, dtype)
        t["bound_by"] = "operations"
        t["tflops"] = K5_FLOPS[role] * b * h * n_q * n_k * 64 / t["ms"] / 1e9
        t["bound_share"] = t["bound_ms"] / t["ms"]
        if dtype == torch.float32:
            t["fp32_fma_bound_ms"] = k5_fma_bound_ms(role, shape)
    kernels = {names[role]: t for role, t in times.items()}
    if dtype == torch.float32:
        kernels["flash_f32_split"] = split_times(torch, attention, shape,
                                                 (q, k, v, do))
        kernels["flash_f32_split_forward"] = split_times(
            torch, attention, shape, (k, v))
    pair_ms = sum(kernels[n]["ms"] for n in kernels
                  if n not in (names["forward"], "flash_f32_split_forward"))
    times["forward"]["ex2_bound_ms"] = b * h * n_q * n_k / H100_EX2_PER_S * 1e3
    times["forward"]["max_abs_err"] = checks["o"]["max_abs_err"]
    times["backward_dkv"]["max_abs_err"] = max(
        checks["dk"]["max_abs_err"], checks["dv"]["max_abs_err"])
    times["backward_dq"]["max_abs_err"] = checks["dq"]["max_abs_err"]
    fb_iters = 5 if dtype == torch.bfloat16 else 3
    fwd_bwd_ms = {
        "kernels": time_ms(torch, fwd_bwd(attention.flash_attention), fb_iters),
        "plain": time_ms(torch, fwd_bwd(attention._dense), 3, warmup=1),
        "sdpa": time_ms(torch, fwd_bwd(sdpa), fb_iters)}
    return {"shape": list(shape), "dtype": str(dtype), "vs_plain": checks,
            "vs_dense_f32_autograd": dense, "kernels": kernels,
            "backward_pair_ms": pair_ms, "sdpa_backward_ms": sdpa_bwd,
            "fwd_bwd_ms": fwd_bwd_ms}


def view_masked_phase(torch, attention, spec: tuple, gen, dev) -> dict:
    """The view-masked kernel at one cross-attention shape with seeded
    bf16 inputs: O and lse against the plain version (O within 1e-2 of
    max |O|, lse within 1e-4); its time beside its bound (4 n_q n_k' 64
    FLOPs over the n_k' keys each row may see, at 989 TFLOP/s), the plain
    version's, the dense path's it replaces, and SDPA's with a boolean
    mask (the yardstick; the port never calls it)."""
    import torch.nn.functional as F

    from spfsplatv2_tpu_torch.models.croco.backbone import (
        build_cross_view_mask,
    )

    views, num_target, (lo, hi), l = spec
    mask = build_cross_view_mask(views, num_target, device=dev)[lo:hi]
    n_q, n_k = (hi - lo) * l, views * l
    q, k, v = (torch.randn(1, 12, n, 64, generator=gen, device=dev).to(
        torch.bfloat16) for n in (n_q, n_k, n_k))
    scale = 64**-0.5
    o, lse = attention.flash_view_masked_cuda(q, k, v, scale, mask, l)
    torch.cuda.synchronize()
    o_p, lse_p = attention.flash_view_masked_plain(q, k, v, scale, mask, l)
    checks = {"o": max_err(o, o_p), "lse": max_err(lse, lse_p)}
    del o_p, lse_p
    for key, tol in (("o", 1e-2), ("lse", 1e-4)):
        if not checks[key]["max_abs_err"] <= tol * checks[key]["ref_max_abs"]:
            fail(f"view-masked kernel {spec} {key} vs plain: {checks[key]}")
    seen = int((mask == 0).sum()) * l * l * 12  # logits a row may see
    bound = 4 * 64 * seen / 989e12 * 1e3
    ms = time_ms(torch, lambda: attention.flash_view_masked_cuda(
        q, k, v, scale, mask, l), 20)
    with torch.no_grad():
        dense_ms = time_ms(torch, lambda: attention.sdpa_view_masked(
            q, k, v, scale, mask, l, chunked_min_kv=1 << 30), 3, 1)
    plain_ms = time_ms(torch, lambda: attention.flash_view_masked_plain(
        q, k, v, scale, mask, l), 2, 1)
    allowed = (mask.repeat_interleave(l, 0).repeat_interleave(l, 1) == 0)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=allowed, scale=scale), 5, 1)
    return {"shape": [1, 12, n_q, n_k], "tokens_per_view": l,
            "vs_plain": checks, "ms": ms, "bound_ms": bound,
            "roofline_pct": 100 * bound / ms,
            "ex2_bound_ms": seen / H100_EX2_PER_S * 1e3,
            "plain_ms": plain_ms, "dense_path_ms": dense_ms,
            "library_ms": library_ms}


def split_times(torch, attention, shape: tuple, inputs: tuple) -> dict:
    """A split pre-pass's entry, the backward's on (q, k, v, dO) or the
    forward's on (k, v): its time beside its byte bound and its plain
    version's (no one PyTorch call computes it; the kernels' times with
    it stand beside SDPA's); bit-identical to the plain version where
    `f32_split_check` ran."""
    if len(inputs) == 4:
        fn, plain, nbytes = (attention.flash_f32_split_cuda,
                             attention.flash_f32_split_plain,
                             split_bytes(shape))
    else:
        fn, plain, nbytes = (attention.flash_f32_split_forward_cuda,
                             attention.flash_f32_split_forward_plain,
                             split_forward_bytes(shape))
    ms = time_ms(torch, lambda: fn(*inputs), 10)
    bound = nbytes / H100_BYTES_PER_S * 1e3
    return {"ms": ms, "plain_ms": time_ms(torch, lambda: plain(*inputs), 3,
                                          warmup=1),
            "bound_ms": bound, "bound_by": "bytes", "bound_share": bound / ms,
            "library_ms": None, "max_abs_err": 0.0}


def k5_train_shape(torch, attention, shape: tuple, gen, dev, dtype) -> dict:
    """K5's backward pair of `dtype` at one shape that a 1024^2 train
    step's autograd gave it, on seeded inputs: the first batch element
    held against the plain versions (the whole batch's float32 logits
    would take tens of GB), both kernels timed beside SDPA's backward;
    float32: the split pre-passes and each kernel launched twice with
    identical bits (the splits also bit for bit against their plain
    versions), the splits timed beside their byte bounds, and the forward
    (which the step runs at the same shape) held against its plain
    version on the first batch element and timed beside SDPA's
    forward."""
    import torch.nn.functional as F

    b, h, n_q, n_k = shape
    scale = 64**-0.5
    grad_tol = K5_TOLS[str(dtype).removeprefix("torch.")][2]
    names = k5_kernels(attention, dtype)
    q, k, v, do, o, lse, di = k5_inputs(torch, attention, shape, gen, dev,
                                        dtype)
    args = (q, k, v, do, lse, di, scale)
    split = None
    if dtype == torch.float32:
        split = f32_split_check(torch, attention, q, k, v, do,
                                f"train shape {shape}")
        dk, dv, dq = pair_twice(torch, attention, args, split,
                                f"train shape {shape}")
    else:
        dk, dv = attention.flash_backward_dkv_cuda(*args)
        dq = attention.flash_backward_dq_cuda(*args)
    torch.cuda.synchronize()
    first = [x[:1] for x in args[:6]] + [scale]
    dk_p, dv_p = attention.flash_backward_dkv_plain(*first)
    dq_p = attention.flash_backward_dq_plain(*first)
    checks = {"dq": max_err(dq[:1], dq_p), "dk": max_err(dk[:1], dk_p),
              "dv": max_err(dv[:1], dv_p)}
    if dtype == torch.float32:
        o_p, lse_p = attention.flash_forward_plain(q[:1], k[:1], v[:1], scale)
        checks["o"], checks["lse"] = max_err(o[:1], o_p), max_err(lse[:1],
                                                                  lse_p)
        del o_p, lse_p
    for key, c in checks.items():
        tol = {"o": K5_TOLS["float32"][0],
               "lse": K5_TOLS["float32"][1]}.get(key, grad_tol)
        if not c["max_abs_err"] <= tol * c["ref_max_abs"]:
            fail(f"K5 {dtype} {key} at train shape {shape} vs plain: {c}")
    del o, dk, dv, dq, dk_p, dv_p, dq_p
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, scale=scale)
    iters = 10 if dtype == torch.bfloat16 else 3
    sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), iters)
    kernels = {}
    for role in ("backward_dkv", "backward_dq"):
        fn = getattr(attention, f"flash_{role}_cuda")
        ms = time_ms(torch, lambda fn=fn: fn(*args, split=split), iters)
        bound = k5_bound_ms(torch, role, shape, dtype)
        kernels[names[role]] = {
            "ms": ms, "tflops": K5_FLOPS[role] * b * h * n_q * n_k * 64 / ms
            / 1e9, "bound_ms": bound, "bound_by": "operations",
            "bound_share": bound / ms, "library_ms": sdpa_bwd}
        if dtype == torch.float32:
            kernels[names[role]]["fp32_fma_bound_ms"] = k5_fma_bound_ms(
                role, shape)
    if dtype == torch.float32:
        kernels["flash_f32_split"] = split_times(torch, attention, shape,
                                                 (q, k, v, do))
    pair_ms = sum(t["ms"] for t in kernels.values())
    if dtype == torch.float32:
        ms = time_ms(torch, lambda: attention.flash_forward_cuda(
            q, k, v, scale), iters)
        bound = k5_bound_ms(torch, "forward", shape, dtype)
        kernels[names["forward"]] = {
            "ms": ms, "tflops": K5_FLOPS["forward"] * b * h * n_q * n_k * 64
            / ms / 1e9, "bound_ms": bound, "bound_by": "operations",
            "bound_share": bound / ms,
            "fp32_fma_bound_ms": k5_fma_bound_ms("forward", shape),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale), iters),
            "max_abs_err": checks["o"]["max_abs_err"]}
        kernels["flash_f32_split_forward"] = split_times(
            torch, attention, shape, (k, v))
    return {"shape": list(shape), "dtype": str(dtype),
            "vs_plain_first_batch": checks, "kernels": kernels,
            "pair_ms": pair_ms, "sdpa_backward_ms": sdpa_bwd}


def run_train_step(torch, dev, state, step_fn, batch) -> dict:
    """One train step, timed to its end on the card; checks that the loss
    is finite and that parameters moved exactly when the update applied."""
    encoder, optimizer = state.encoder, state.optimizer
    snapshot = [p.detach().clone() for p in encoder.parameters()]
    skipped = optimizer.skipped_count
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not all(v == v and abs(v) != float("inf")
               for k, v in metrics.items() if k.startswith("loss/")):
        fail(f"train step {state.step}: non-finite loss {metrics}")
    moved = sum(not torch.equal(a, p) for a, p in
                zip(snapshot, encoder.parameters()))
    del snapshot
    if optimizer.skipped_count > skipped:
        branch = "skipped"
        if moved:
            fail(f"train step {state.step}: skipped, yet {moved} "
                 "parameters changed")
    else:
        branch = "applied"
        if not moved:
            fail(f"train step {state.step}: applied, yet no parameter "
                 "changed")
    return {"step": state.step, "ms": ms, "branch": branch,
            "params_changed": moved,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "metrics": metrics}


def render_vs_plain(torch, decode, cams_args, gaussians, where: str) -> tuple:
    """One render through K1 and K3 against the same render with both
    dispatchers routed to their plain versions on the card (phase 4's
    bars, depth's relative to its max), and K3 exact on each prefix sum's
    real input; -> (each output's check, the prefix sums' n)."""
    from spfsplatv2_tpu_torch.ops import cuda_lib, raster_cuda, raster_tiled
    from spfsplatv2_tpu_torch.ops.segscan import cumsum_1d_cuda, cumsum_1d_plain

    scans = []
    with torch.no_grad():
        kern = decode(gaussians, *cams_args)
        cuda_lib.reset_launch_counts()
        with plain_dispatch(raster_tiled, raster_cuda, cumsum_1d_plain, scans):
            plain = decode(gaussians, *cams_args)
    if cuda_lib.launch_counts["composite_forward"] or cuda_lib.launch_counts[
            "cumsum_1d"] or not scans:
        fail(f"{where} plain render: launches {cuda_lib.launches()}, "
             f"{len(scans)} prefix sums")
    depth_max = float(plain.depth.abs().max())
    check = {}
    for name, a, b, atol, hard in (
            ("color", kern.color, plain.color, 3e-5, 5e-3),
            ("depth", kern.depth, plain.depth, 6e-5 * depth_max,
             4e-3 * depth_max),
            ("alpha", kern.alpha, plain.alpha, 3e-5, 5e-3)):
        diff = (a - b).abs()
        frac_ok = float((diff <= atol).float().mean())
        check[name] = {"max_abs_err": float(diff.max()),
                       "frac_within": frac_ok, "atol": atol}
        if not bool(torch.isfinite(a).all()) or float(diff.max()) > hard \
                or frac_ok < 0.999:
            fail(f"{where} render {name} vs plain: {check[name]}")
    for x in scans:
        if not torch.equal(cumsum_1d_cuda(x), cumsum_1d_plain(x)):
            fail(f"K3 differs from torch.cumsum on the {where} binning's "
                 f"input, n={x.shape[0]}")
    return check, [x.shape[0] for x in scans]


def conv_probe(torch, dev, convs: dict, maps: dict) -> dict:
    """Float32 convolutions alone (TF32 off) through cuDNN and through
    PyTorch's own im2col + GEMM (cuDNN off, as `without_cudnn` runs
    them).  `convs`: name -> (in channels, out channels, kernel side,
    {image side: map side}); `maps`: image side -> the map counts to
    probe.  Each gives the forward's ms and its peak GB above the inputs
    (an out-of-memory error reads as infinite)."""
    import torch.nn.functional as F

    from spfsplatv2_tpu_torch.utils.cudnn import without_cudnn

    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for name, (c_in, c_out, ksize, sides) in convs.items():
        w = torch.randn(c_out, c_in, ksize, ksize, generator=gen,
                        device=dev) * 0.02
        for image, side in sides.items():
            for n in maps[image]:
                x = torch.randn(n, c_in, side, side, generator=gen, device=dev)
                conv = lambda: F.conv2d(x, w, padding=ksize // 2)  # noqa: E731
                row = {"maps": n, "map_side": side}
                for how, f in (("cudnn", conv),
                               ("no_cudnn", lambda: without_cudnn(conv))):
                    try:
                        f()
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats(dev)
                        base = torch.cuda.memory_allocated(dev)
                        row[f"{how}_ms"] = time_ms(torch, f, 3, warmup=0)
                        row[f"{how}_peak_gb"] = (
                            torch.cuda.max_memory_allocated(dev) - base) / 1e9
                    except torch.cuda.OutOfMemoryError:
                        row[f"{how}_ms"] = row[f"{how}_peak_gb"] = float("inf")
                    torch.cuda.empty_cache()
                out[f"{name}@{image}px_n{n}"] = row
                del x
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def first_k2_launch(raster_cuda):
    """Record K2's inputs and rows at its first launch, and that camera's
    bins, on the way through (the launch counts stay the wrapper's);
    yields a dict that holds "args", "rows", "bins" and "g" after it."""
    seen = {}
    k2_inner, acc_inner = (raster_cuda.composite_backward,
                           raster_cuda.accumulate_rows)

    def capture_k2(*args):
        rows = k2_inner(*args)
        seen.setdefault("args", args)
        seen.setdefault("rows", rows)
        return rows

    def capture_bins(drows, bins, n_gauss):
        seen.setdefault("bins", bins)
        seen.setdefault("g", n_gauss)
        return acc_inner(drows, bins, n_gauss)

    raster_cuda.composite_backward = capture_k2
    raster_cuda.accumulate_rows = capture_bins
    try:
        yield seen
    finally:
        raster_cuda.composite_backward = k2_inner
        raster_cuda.accumulate_rows = acc_inner


def check_first_k2(torch, raster_cuda, seen: dict, where: str) -> dict:
    """The recorded first K2 launch's rows against K2's plain version on
    the same inputs and bins."""
    with torch.no_grad():
        rows_p = raster_cuda.composite_backward_plain(*seen["args"])
    return check_k2_rows(raster_cuda.accumulate_rows, seen["rows"], rows_p,
                         seen["bins"], seen["g"], where)


def ortho_phase(torch, dev, where: str, gaussians, c2w, intrinsics, near,
                far, size: tuple, dec_cfg, seed: int,
                order_sample: int = 0) -> dict:
    """The orthographic render (`decode_orthographic`) of the first
    scene's Gaussians from the first context view's camera `c2w` (1, 1,
    4, 4), its world-space width and height the 1st-99th percentile span
    of the means' x and y in that camera: through K1 and K3 against the
    plain versions (`render_vs_plain`), one render and the backward of a
    photometric loss with respect to the means and the pose with the
    launch counts read around exactly that (K1 1, K3 2, K2 1), the first
    K2 launch against its plain version, and the render's, the
    forward-plus-backward's and K1's and K2's ms beside the perspective
    render's of the same Gaussians from the same camera.  With
    `order_sample`, also the share of pixels whose colour is within 1e-4
    of the exact depth order's (rank key) on that many of the Gaussians:
    under JAX's quantized key (`decode_splatting` on the orthographic
    cameras) and under the port's relative key (`decode_orthographic`),
    the perspective render's quantized key beside them.  Its random draws
    come from `seed`."""
    from spfsplatv2_tpu_torch.models.decoder import (
        decode_orthographic,
        decode_splatting,
        orthographic_cameras,
    )
    from spfsplatv2_tpu_torch.ops import cuda_lib, raster_cuda

    gen = torch.Generator(device=dev).manual_seed(seed)
    g = gaussians.map(lambda a: a[:1].detach())
    rot, origin = c2w[0, 0, :3, :3], c2w[0, 0, :3, 3]
    xy = ((g.means[0] - origin) @ rot)[:, :2]
    lo, hi = torch.quantile(xy, torch.tensor([0.01, 0.99], device=dev), dim=0)
    width, height = (hi - lo).reshape(2, 1, 1)
    views = {
        "ortho": (decode_orthographic, (width, height, near, far, size,
                                        dec_cfg)),
        "perspective": (decode_splatting, (intrinsics, near, far, size,
                                           dec_cfg)),
    }
    check, scan_ns = render_vs_plain(torch, decode_orthographic,
                                     (c2w, *views["ortho"][1]), g, where)
    target = torch.rand((1, 1, *size, 3), generator=gen, device=dev)

    def render(view):
        decode, args = views[view]
        with torch.no_grad():
            return decode(g, c2w, *args)

    def loss_and_grads(view):
        decode, args = views[view]
        means = g.means.clone().requires_grad_(True)
        pose = c2w.clone().requires_grad_(True)
        out = decode(dataclasses.replace(g, means=means), pose, *args)
        loss = ((out.color - target) ** 2).mean()
        return out, torch.autograd.grad(loss, [means, pose])

    cuda_lib.reset_launch_counts()
    with first_k2_launch(raster_cuda) as seen:
        out, grads = loss_and_grads("ortho")
    counts = cuda_lib.launches()
    want = {k: 0 for k in counts}
    want.update(composite_forward=1, cumsum_1d=2, composite_backward=1)
    if counts != want:
        fail(f"{where}: launch counts {counts}, expected {want}")
    if not all(bool(torch.isfinite(x).all()) for x in (*grads, out.color)):
        fail(f"{where}: non-finite render or gradient")
    grad_max = [float(x.abs().max()) for x in grads]
    del out, grads
    k2 = check_first_k2(torch, raster_cuda, seen, where)
    # K1 and K2 timed on each view's bins (K2's recorded inputs, which end
    # in the dispatcher's chunk, detached: the plain walk on the saved
    # rows would otherwise build an autograd graph of every chunk's
    # temporaries), beside their bounds.
    kernels = {}
    for view in views:
        if view != "ortho":
            with first_k2_launch(raster_cuda) as seen:
                loss_and_grads(view)
        kargs = [a.detach() if torch.is_tensor(a) else a
                 for a in seen["args"]]
        bins = seen["bins"]
        del seen
        _, walked, blended = raster_cuda.composite_forward_plain_work(
            *kargs[:5])
        kernels[view] = {"n_live": int(bins.n_live), "pairs_walked": walked,
                         "pairs_blended": blended,
                         "tiles_occupied": int((bins.counts > 0).sum()),
                         "max_tile_entries": int(bins.counts.max())}
        for name, fn, fargs, backward in (
                ("composite_forward", raster_cuda.composite_forward_cuda,
                 kargs[:5], False),
                ("composite_backward", raster_cuda.composite_backward_cuda,
                 kargs[:7], True)):
            kernels[view][name] = {
                "ms": time_ms(torch, lambda fn=fn, fargs=fargs: fn(*fargs), 20),
                **composite_bound(bins, walked, blended, kargs[5].numel(),
                                  backward)}
    once = {v: render(v) for v in views}
    result = {
        "phase": where, "g": g.means.shape[1], "hw": list(size),
        "width": float(width), "height": float(height),
        "render_vs_plain": check, "k3_exact_on_inputs_n": scan_ns,
        "k2_vs_plain": k2, "launches": counts,
        "grad_max_abs": {"means": grad_max[0], "c2w": grad_max[1]},
        "kernels": kernels,
        "dropped_entries": {v: int(o.dropped_entries.sum())
                            for v, o in once.items()},
        "alpha_mean": {v: float(o.alpha.mean()) for v, o in once.items()},
        **{f"{v}_render_ms": time_ms(torch, lambda v=v: render(v), 10)
           for v in views},
        **{f"{v}_fwd_bwd_ms": time_ms(torch, lambda v=v: loss_and_grads(v),
                                      10) for v in views},
    }
    del once
    if order_sample:
        idx = torch.randperm(g.means.shape[1], generator=gen,
                             device=dev)[:order_sample]
        sub = g.map(lambda a: a[:, idx])
        rank_cfg = dataclasses.replace(
            dec_cfg, rasterizer=dataclasses.replace(dec_cfg.rasterizer,
                                                    depth_key="rank"))
        cams = orthographic_cameras(c2w, width, height, near, far)
        persp = (c2w, intrinsics, near, far, size)
        with torch.no_grad():
            renders = {
                "exact": decode_splatting(sub, *cams, size, rank_cfg),
                "jax_quantized": decode_splatting(sub, *cams, size, dec_cfg),
                "port_relative": decode_orthographic(
                    sub, c2w, *views["ortho"][1]),
                "perspective_exact": decode_splatting(sub, *persp, rank_cfg),
                "perspective_quantized": decode_splatting(sub, *persp,
                                                          dec_cfg)}

        def share(name, exact="exact"):
            diff = (renders[name].color - renders[exact].color).abs().amax(-1)
            return float((diff <= 1e-4).float().mean())

        result["order_agreement_within_1e-4"] = {
            "g": order_sample, "jax_quantized": share("jax_quantized"),
            "port_relative": share("port_relative"),
            "perspective_quantized": share("perspective_quantized",
                                           "perspective_exact")}
        if result["order_agreement_within_1e-4"]["port_relative"] < 0.999:
            fail(f"{where}: the relative key's render departs from the exact "
                 f"depth order: {result['order_agreement_within_1e-4']}")
    emit(result)
    return result


def encoder_pass_capturing_k5(torch, attention, encoder, ex) -> tuple:
    """One encoder pass on request `ex` with every flash-branch call's q,
    k, v and scale recorded; -> (the encoder's output, the calls)."""
    captured = []
    flash_inner = attention.flash_attention

    def capture(q_, k_, v_, s_):
        captured.append((q_.contiguous(), k_.contiguous(), v_.contiguous(), s_))
        return flash_inner(q_, k_, v_, s_)

    attention.flash_attention = capture
    # In `train()` the forward runs eagerly (a graph replay calls no
    # Python), with the same arithmetic: the model has no dropout.
    encoder.train()
    try:
        with torch.no_grad():
            c, t = ex["context"], ex["target"]
            out = encoder(c["image"][None], c["intrinsics"][None],
                          t["image"][None], t["intrinsics"][None])
    finally:
        attention.flash_attention = flash_inner
        encoder.eval()
    return out, captured


def serve_requests(torch, dev, encoder, requests, size, dec_cfg, eval_cfg):
    """`evaluate_example` on each request, with the kernels' launch counts
    read around exactly those requests; -> (results with their times and
    peak bytes, the counts)."""
    from spfsplatv2_tpu_torch.evaluation.benchmarker import Benchmarker
    from spfsplatv2_tpu_torch.evaluation.evaluator import evaluate_example
    from spfsplatv2_tpu_torch.ops import cuda_lib

    results = []
    cuda_lib.reset_launch_counts()
    for ex in requests:
        bench = Benchmarker(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = evaluate_example(encoder, ex, size, dec_cfg, eval_cfg,
                               benchmarker=bench, device=dev)
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        res["times"] = bench.summarize()
        results.append(res)
    return results, cuda_lib.launches()


def f32_phases(torch, dev, request, train_batch, lpips, gen) -> dict:
    """The flagship at 1024^2 with compute_dtype="float32" (phases
    "K5_f32", "serving_1024_f32", "train_1024_f32", "K5_f32_train");
    returns each path's launch counts and the checks and times of K5's
    float32 kernels."""
    from spfsplatv2_tpu_torch.evaluation.evaluator import (
        EvalConfig,
        evaluate_example,
    )
    from spfsplatv2_tpu_torch.models import build_encoder
    from spfsplatv2_tpu_torch.models.croco.backbone import CrocoBackboneConfig
    from spfsplatv2_tpu_torch.models.decoder import (
        LONG_CONTEXT_DECODER,
        decode_splatting,
    )
    from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config
    from spfsplatv2_tpu_torch.ops import attention, cuda_lib, raster_cuda
    from spfsplatv2_tpu_torch.training import loop
    from spfsplatv2_tpu_torch.training.optim import Optimizer, OptimizerConfig
    from spfsplatv2_tpu_torch.training.step import (
        HBMBudgetError,
        LossConfig,
        init_train_state,
        make_train_step,
    )

    # ---- K5_f32: the float32 kernels at the 1024^2 path's shapes --------
    k5 = {}
    for name, shape in K5_SHAPES.items():
        k5[name] = k5_phase(torch, attention, name, shape, gen, dev,
                            torch.float32)
        emit({"phase": "K5_f32", "call": name, **k5[name]})
    torch.cuda.empty_cache()

    # ---- serving_1024_f32: evaluate_example, float32 compute ------------
    size, dec_cfg, eval_cfg = (HW_LONG, HW_LONG), LONG_CONTEXT_DECODER, EvalConfig()
    cfg = SPFSplatV2Config(backbone=CrocoBackboneConfig(compute_dtype="float32"))
    t0 = time.perf_counter()
    encoder = build_encoder(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    evaluate_example(encoder, request(-4, HW_LONG), size, dec_cfg, eval_cfg,
                     device=dev)
    requests = [request(40 + i, HW_LONG) for i in range(F32_REQUESTS)]
    resident = torch.cuda.memory_allocated(dev)
    results, serve_counts = serve_requests(torch, dev, encoder, requests, size,
                                           dec_cfg, eval_cfg)
    # The warm-up request captured the encoder's graph: each request
    # replays it, and K5 runs inside the replay, where only the device
    # trace sees it.
    want = {k: 0 for k in serve_counts}
    want.update(encoder_graph_replay=F32_REQUESTS,
                composite_forward=F32_REQUESTS, cumsum_1d=2 * F32_REQUESTS)
    if serve_counts != want:
        fail(f"serving_1024_f32 launch counts {serve_counts}, expected {want}")
    replayed = replayed_kernels(torch, lambda: evaluate_example(
        encoder, requests[0], size, dec_cfg, eval_cfg, device=dev),
        ("flash_f32_forward_kernel", "flash_f32_split_kernel"))
    if set(replayed.values()) != {K5_PER_PASS}:
        fail(f"serving_1024_f32: a replayed request ran {replayed} K5 "
             f"kernels, not {K5_PER_PASS} each")
    for i, res in enumerate(results):
        vals = [*res["psnr"], *res["ssim"], *res["pose_rot_err_deg"]]
        if tuple(res["rendered"].shape) != (1, *size, 3) or not bool(
                torch.isfinite(res["rendered"]).all()) or not all(
                v == v and abs(v) != float("inf") for v in vals):
            fail(f"float32 1024^2 request {i}: rendered "
                 f"{tuple(res['rendered'].shape)}, metrics {vals}")
    # Encoder block 12's real q, k, v through the float32 kernel against
    # the plain version, then the first request's render through K1 and
    # K3 against their plain versions on the card.
    out, captured = encoder_pass_capturing_k5(torch, attention, encoder,
                                              requests[0])
    if len(captured) != K5_PER_PASS:
        fail(f"float32 1024^2 encoder pass took the flash branch "
             f"{len(captured)} times")
    bq, bk, bv, bscale = captured[K5_CHECK_CALL]
    del captured
    real_check = max_err(attention.flash_forward_cuda(bq, bk, bv, bscale)[0],
                         attention.flash_forward_plain(bq, bk, bv, bscale)[0])
    if bq.dtype != torch.float32 or not real_check["max_abs_err"] <= K5_TOLS[
            "float32"][0] * real_check["ref_max_abs"]:
        fail(f"float32 K5 on encoder block 12's q, k, v ({bq.dtype}) vs "
             f"plain: {real_check}")
    t = requests[0]["target"]
    cams_args = (out["extrinsics_cwt"][:, 2:], t["intrinsics"][None],
                 t["near"][None], t["far"][None], size, dec_cfg)
    render_check, scan_ns = render_vs_plain(
        torch, decode_splatting, cams_args, out["gaussians"], "float32 1024^2")
    emit({"phase": "serving_1024_f32", "requests": F32_REQUESTS,
          "compute_dtype": cfg.backbone.compute_dtype, "init_s": init_s,
          "launches": serve_counts, "replayed_k5_a_request": replayed,
          "encoder_ms": [r["times"]["encoder"]["mean_s"] * 1e3 for r in results],
          "decoder_ms": [r["times"]["decoder"]["mean_s"] * 1e3 for r in results],
          "peak_bytes": [r["peak_bytes"] for r in results],
          "resident_bytes": resident,
          "psnr": [r["psnr"][0] for r in results],
          "dropped_entries": [r["dropped_entries"] for r in results],
          "encoder_block12_qkv": {"shape": list(bq.shape), **real_check},
          "render_vs_plain": render_check, "k3_exact_on_inputs_n": scan_ns})
    del out, results, bq, bk, bv
    torch.cuda.empty_cache()

    # ---- train_1024_f32: make_train_step at b = 2 -----------------------
    encoder.train()
    optimizer = Optimizer(OptimizerConfig(), encoder.named_parameters())
    state = init_train_state(encoder, optimizer)
    batches = [train_batch(50 + i, LONG_BATCH, HW_LONG) for i in range(2)]
    loss_kwargs = dict(image_shape=size, decoder_cfg=dec_cfg,
                       loss_cfg=LossConfig(), lpips=lpips,
                       training_context=False)
    probes = []

    def probe(mb):
        probes.append({"microbatch": mb, "peak_gb": loop.probe_peak_gb(
            state, batches[0], mb, loss_kwargs)})
        return probes[-1]["peak_gb"]

    budget_gb = loop.device_memory_gb(dev)
    t0 = time.perf_counter()
    try:
        microbatch, guard_peak = loop.fit_microbatch(probe, LONG_BATCH, None,
                                                     budget_gb)
    except HBMBudgetError as e:
        fail(f"train_1024_f32: no microbatch fits {budget_gb} GiB: probes "
             f"{probes}: {e}")
    guard_s = time.perf_counter() - t0
    microbatch = microbatch or LONG_BATCH
    step_fn = make_train_step(encoder, optimizer, size, dec_cfg, LossConfig(),
                              lpips, microbatch=microbatch)
    # The (b, h, n_q, n_k) that the steps' autograd gives the backward
    # kernels, recorded on the way through.
    bwd_shapes = []
    dkv_inner = attention.flash_backward_dkv_cuda

    def capture_dkv(q_, k_, *rest):
        bwd_shapes.append((*q_.shape[:3], k_.shape[2]))
        return dkv_inner(q_, k_, *rest)

    attention.flash_backward_dkv_cuda = capture_dkv
    try:
        with first_k2_launch(raster_cuda) as k2_seen:
            cuda_lib.reset_launch_counts()
            steps = [run_train_step(torch, dev, state, step_fn, b)
                     for b in batches]
            train_counts = cuda_lib.launches()
    finally:
        attention.flash_backward_dkv_cuda = dkv_inner
    # Each microbatch pass runs the encoder forward once and, under remat,
    # again in the backward; K1 and K2 run once a target camera, K3 twice.
    passes = len(batches) * (LONG_BATCH // microbatch)
    want = {k: 0 for k in train_counts}
    want.update(flash_f32_forward=2 * K5_PER_PASS * passes,
                flash_f32_split_forward=2 * K5_PER_PASS * passes,
                flash_f32_split=K5_PER_PASS * passes,
                flash_f32_backward_dkv=K5_PER_PASS * passes,
                flash_f32_backward_dq=K5_PER_PASS * passes,
                composite_forward=len(batches) * LONG_BATCH,
                composite_backward=len(batches) * LONG_BATCH,
                cumsum_1d=2 * len(batches) * LONG_BATCH)
    if train_counts != want:
        fail(f"train_1024_f32 launch counts {train_counts}, expected {want}")
    k2_check = check_first_k2(torch, raster_cuda, k2_seen,
                              "float32 1024^2 train step")
    for st in steps:
        emit({"phase": "train_step_1024_f32", "batch": LONG_BATCH,
              "microbatch": microbatch, **st})
    emit({"phase": "train_1024_f32", "batch": LONG_BATCH,
          "microbatch": microbatch,
          "guard": {"peak_gb": guard_peak, "budget_gb": budget_gb,
                    "probes": probes, "seconds": guard_s},
          "steps": len(steps), "launches": train_counts,
          "step_ms": [st["ms"] for st in steps],
          "peak_bytes": max(st["peak_bytes"] for st in steps),
          "branches": [st["branch"] for st in steps],
          "k2_vs_plain": k2_check, "backward_shapes": sorted(set(bwd_shapes))})
    del encoder, optimizer, state, step_fn, batches, steps, k2_seen
    gc.collect()
    torch.cuda.empty_cache()

    # ---- K5_f32_train: the backward pair at the train steps' shapes -----
    k5_train = {}
    for shape in dict.fromkeys(bwd_shapes):
        k5_train[shape] = k5_train_shape(torch, attention, shape, gen, dev,
                                         torch.float32)
        emit({"phase": "K5_f32_train",
              "calls_per_2_steps": bwd_shapes.count(shape), **k5_train[shape]})
    return {"k5": k5, "k5_train": k5_train, "serve": serve_counts,
            "train": train_counts, "real_check": real_check,
            "render_check": render_check, "k2_check": k2_check}


def place_vggt_scene(torch, encoder) -> None:
    """Random weights place neither the points nor the cameras.  Put the
    point head's points near z = 6.4 in front of view 0 (a z bias of 2
    under the inverse-log output) and start the camera head near the
    identity (its last layer shrunk to 0.1, a w bias of 0.25 for each of
    its 4 iterations), as the CPU tests' random weights do."""
    with torch.no_grad():
        encoder.point_head.output_conv2_2.bias[2] += 2.0
        fc2 = encoder.camera_head.pose_branch_fc2
        fc2.weight.mul_(0.1)
        fc2.bias[6] += 0.25


def train_steps(torch, dev, state, cfg, hw, lpips, batches, where: str,
                microbatch=None, distiller=None) -> dict:
    """Train steps of `make_train_step` on `batches` (with `distiller`, the
    teacher), at `microbatch` or, without one, at the microbatch that
    `training/loop.py:fit_microbatch` picks (its probes recorded); the
    launch counts read around exactly those steps must be one K1 and K2
    and two K3 a camera; the first K2 launch is held against its plain
    version on the same inputs and bins."""
    from spfsplatv2_tpu_torch.ops import cuda_lib, raster_cuda
    from spfsplatv2_tpu_torch.training import loop
    from spfsplatv2_tpu_torch.training.step import make_train_step

    batch_size = batches[0]["context"]["image"].shape[0]
    kwargs = dict(decoder_cfg=cfg.decoder, loss_cfg=cfg.loss, lpips=lpips,
                  training_context=cfg.train.training_context,
                  distiller=distiller)
    guard = None
    if microbatch is None:
        probes = []

        def probe(mb):
            probes.append({"microbatch": mb, "peak_gb": loop.probe_peak_gb(
                state, batches[0], mb, {"image_shape": hw, **kwargs})})
            return probes[-1]["peak_gb"]

        budget_gb = loop.device_memory_gb(dev)
        t0 = time.perf_counter()
        microbatch, peak = loop.fit_microbatch(probe, batch_size, None,
                                               budget_gb)
        guard = {"peak_gb": peak, "budget_gb": budget_gb, "probes": probes,
                 "seconds": time.perf_counter() - t0}
        microbatch = microbatch or batch_size
    step_fn = make_train_step(state.encoder, state.optimizer, hw,
                              microbatch=microbatch, **kwargs)
    with first_k2_launch(raster_cuda) as k2_seen:
        cuda_lib.reset_launch_counts()
        steps = [run_train_step(torch, dev, state, step_fn, b) for b in batches]
        counts = cuda_lib.launches()
    cams = len(batches) * batch_size
    want = {k: 0 for k in counts}
    want.update(composite_forward=cams, composite_backward=cams,
                cumsum_1d=2 * cams)
    if counts != want:
        fail(f"{where} launch counts {counts}, expected {want}")
    k2_check = check_first_k2(torch, raster_cuda, k2_seen, f"{where} step")
    return {"batch": batch_size, "microbatch": microbatch, "guard": guard,
            "steps": steps, "launches": counts, "k2_vs_plain": k2_check,
            "e_pad": k2_seen["bins"].e_pad, "g": k2_seen["g"]}


def train_summary(run: dict) -> dict:
    """A `train_steps` result's summary line."""
    steps = run["steps"]
    return {"batch": run["batch"], "microbatch": run["microbatch"],
            "guard": run["guard"], "steps": len(steps),
            "launches": run["launches"], "step_ms": [st["ms"] for st in steps],
            "peak_bytes": max(st["peak_bytes"] for st in steps),
            "branches": [st["branch"] for st in steps],
            "k2_vs_plain": run["k2_vs_plain"], "e_pad": run["e_pad"],
            "g": run["g"]}


def cli_train(torch, dev, argv: list, wraps: dict) -> dict:
    """`main.main(argv)` (mode=train) in process with each train step's
    kernel launches counted apart, every logged metric and the memory
    guard's result recorded; `wraps` maps other names of
    `training/loop.py` to a function of the real one that returns its
    stand-in.  -> rc, seconds, logged metrics by step, guards, each
    step's launches and the call's launches."""
    from spfsplatv2_tpu_torch import main as cli
    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.training import loop

    logged, guards, step_counts = {}, [], []

    def make_train_step(real):
        def build(*args, **kwargs):
            step = real(*args, **kwargs)

            def counted(state, batch_):
                before = cuda_lib.launches()
                result = step(state, batch_)
                step_counts.append({k: v - before[k]
                                    for k, v in cuda_lib.launches().items()})
                return result

            return counted

        return build

    def run_training(real):
        def run(cfg_, log_fn=None, **kwargs):
            def log(step, metrics):
                logged.setdefault(step, {}).update(metrics)
                log_fn(step, metrics)

            result = real(cfg_, log_fn=log, **kwargs)
            guards.append(result["guard"])
            return result

        return run

    wraps = {"make_train_step": make_train_step, "run_training": run_training,
             **wraps}
    real = {name: getattr(loop, name) for name in wraps}
    for name, wrap in wraps.items():
        setattr(loop, name, wrap(real[name]))
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = run_cli(cli, argv)
    finally:
        for name, fn in real.items():
            setattr(loop, name, fn)
    seconds = time.perf_counter() - t0
    counts = cuda_lib.launches()
    gc.collect()
    torch.cuda.empty_cache()
    return {"rc": rc, "seconds": seconds, "logged": logged, "guards": guards,
            "step_launches": step_counts, "launches": counts}


def vggt_phases(torch, repo: Path, dev, request, train_batch) -> dict:
    """The VGGT-1B family at full width, phases "vggt_serve" and
    "vggt_train"; returns each path's launch counts and the K2 check."""
    from spfsplatv2_tpu_torch.config import load_config
    from spfsplatv2_tpu_torch.evaluation.evaluator import (
        EvalConfig,
        evaluate_example,
    )
    from spfsplatv2_tpu_torch.losses.lpips import build_lpips
    from spfsplatv2_tpu_torch.models import get_encoder
    from spfsplatv2_tpu_torch.models.decoder import decode_splatting
    from spfsplatv2_tpu_torch.training.optim import Optimizer
    from spfsplatv2_tpu_torch.training.step import init_train_state

    cfg = load_config([repo / VGGT_PRESET],
                      ["checkpointing.pretrained_weights=null"])
    hw = tuple(cfg.image_shape)
    t0 = time.perf_counter()
    encoder = get_encoder(cfg.encoder, seed=SEED, device=dev)
    place_vggt_scene(torch, encoder)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in encoder.parameters())
    if n_params != VGGT_PARAMS:
        fail(f"the VGGT encoder has {n_params} parameters, not {VGGT_PARAMS}")
    emit({"phase": "vggt_init", "preset": VGGT_PRESET, "params": n_params,
          "seconds": time.perf_counter() - t0, "image_shape": list(hw),
          "compute_dtype": cfg.encoder.spfsplatv2l.aggregator.compute_dtype})

    # ---- 19. vggt_serve: evaluate_example, 3 requests ------------------
    dec_cfg, eval_cfg = cfg.decoder, EvalConfig()
    evaluate_example(encoder, request(-3, hw[0]), hw, dec_cfg, eval_cfg,
                     device=dev)
    requests = [request(20 + i, hw[0]) for i in range(VGGT_REQUESTS)]
    # What the process holds before the requests (the encoder's weights
    # and what earlier phases left), inside each request's peak.
    resident = torch.cuda.memory_allocated(dev)
    results, serve_counts = serve_requests(torch, dev, encoder, requests, hw,
                                           dec_cfg, eval_cfg)
    # The warm-up request captured the encoder's graph: each request
    # replays it.
    want = {k: 0 for k in serve_counts}
    want.update(composite_forward=VGGT_REQUESTS, cumsum_1d=2 * VGGT_REQUESTS,
                encoder_graph_replay=VGGT_REQUESTS)
    if serve_counts != want:
        fail(f"vggt_serve launch counts {serve_counts}, expected {want}")
    for i, res in enumerate(results):
        vals = [*res["psnr"], *res["ssim"], *res["pose_rot_err_deg"],
                *res["pose_transl_err_deg"]]
        if tuple(res["rendered"].shape) != (1, *hw, 3) or not bool(
                torch.isfinite(res["rendered"]).all()) or not all(
                v == v and abs(v) != float("inf") for v in vals):
            fail(f"vggt request {i}: rendered {tuple(res['rendered'].shape)}, "
                 f"metrics {vals}")
    # The first request's render through K1 and K3 against their plain
    # versions on the card, on the encoder's own Gaussians and pose.
    c, t = requests[0]["context"], requests[0]["target"]
    with torch.no_grad():
        out = encoder(c["image"][None], c["intrinsics"][None], t["image"][None],
                      t["intrinsics"][None])
    for key in ("pts3d", "pts3d_conf", "extrinsics_cwt", "depths"):
        if not bool(torch.isfinite(out[key]).all()):
            fail(f"vggt encoder output {key} is not finite")
    cams_args = (out["extrinsics_cwt"][:, 2:], t["intrinsics"][None],
                 t["near"][None], t["far"][None], hw, dec_cfg)
    render_check, scan_ns = render_vs_plain(
        torch, decode_splatting, cams_args, out["gaussians"], "vggt 224^2")
    emit({"phase": "vggt_serve", "requests": VGGT_REQUESTS,
          "launches": serve_counts,
          "encoder_ms": [r["times"]["encoder"]["mean_s"] * 1e3 for r in results],
          "decoder_ms": [r["times"]["decoder"]["mean_s"] * 1e3 for r in results],
          "peak_bytes": [r["peak_bytes"] for r in results],
          "resident_bytes": resident,
          "psnr": [r["psnr"][0] for r in results],
          "pose_rot_err_deg": [r["pose_rot_err_deg"][0] for r in results],
          "dropped_entries": [r["dropped_entries"] for r in results],
          "points_in_front": float((out["depths"] > 0).float().mean()),
          "render_vs_plain": render_check, "k3_exact_on_inputs_n": scan_ns,
          "conv_probe": conv_probe(torch, dev, VGGT_CONVS, {224: (1, 2, 10)})})
    del out, results
    torch.cuda.empty_cache()

    # ---- 20. vggt_train: make_train_step at b = 10 ---------------------
    lpips = build_lpips(seed=SEED, device=dev)
    encoder.train()
    state = init_train_state(encoder, Optimizer(cfg.optimizer,
                                                encoder.named_parameters()))
    batches = [train_batch(30 + i, cfg.trainer.batch_size, hw[0])
               for i in range(VGGT_STEPS)]
    run = train_steps(torch, dev, state, cfg, hw, lpips, batches, "vggt_train")
    for st in run["steps"]:
        emit({"phase": "vggt_train_step", "batch": run["batch"],
              "microbatch": run["microbatch"], **st})
    emit({"phase": "vggt_train", **train_summary(run)})
    return {"serve": serve_counts, "train": run["launches"],
            "render_check": render_check, "scan_ns": scan_ns,
            "k2_check": run["k2_vs_plain"]}


def vggt_cli_phase(torch, repo: Path, dev) -> dict:
    """Phase "vggt_cli": the command line on the VGGT preset, mode=train
    for 2 steps on phase 14's synthetic chunks (360x640, which the preset
    resizes to 224^2), then mode=test from the saved checkpoint; returns
    each call's kernel launch counts."""
    import numpy as np

    from spfsplatv2_tpu_torch import main as cli
    from spfsplatv2_tpu_torch.config import load_config
    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.training import loop

    root = repo / "build" / "cli"
    out_dir, test_dir = root / "vggt_out", root / "vggt_test_out"
    overrides = [f"dataset.roots=[{root}]", f"trainer.max_steps={VGGT_CLI_STEPS}",
                 "trainer.val_check_interval=1",
                 "checkpointing.pretrained_weights=null",
                 f"output_dir={out_dir}", "checkpointing.every_n_train_steps=0",
                 "train.print_log_every_n_steps=1",
                 f"evaluation_sampler.index_path={root / 'index.json'}",
                 f"test.output_path={test_dir}", "test.save_image=false"]
    argv = ["--config", str(repo / VGGT_PRESET), *overrides]
    batch = load_config([repo / VGGT_PRESET], overrides).trainer.batch_size
    saves = []

    def save_checkpoint(real):
        def save(ckpt_dir, state, step):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            path = real(ckpt_dir, state, step)
            saves.append({"step": step, "seconds": time.perf_counter() - t,
                          "bytes": path.stat().st_size})
            return path

        return save

    run = cli_train(torch, dev, argv, {"save_checkpoint": save_checkpoint})
    logged = run["logged"]
    losses = [m["loss/total"] for s, m in sorted(logged.items())
              if "loss/total" in m]
    if run["rc"] != 0 or len(saves) != 1 or len(losses) != VGGT_CLI_STEPS \
            or not all(np.isfinite(losses)):
        fail(f"vggt_cli train: rc {run['rc']}, {len(saves)} saves, losses "
             f"{losses}")
    (guard,) = run["guards"]
    # Each step's own launches: one K1 and K2 and two K3 a camera (a
    # probe that runs out of memory stops part way, so the totals, which
    # add the guard's probes and the validation, are only reported).
    want = {k: 0 for k in run["launches"]}
    want.update(composite_forward=batch, composite_backward=batch,
                cumsum_1d=2 * batch)
    if run["step_launches"] != [want] * VGGT_CLI_STEPS:
        fail(f"vggt_cli steps' launch counts {run['step_launches']}, expected "
             f"{want} each")
    ckpt_path = out_dir / "checkpoints" / "step_-1"
    head = loop.load_checkpoint(ckpt_path)
    n_params = sum(t.numel() for t in head["encoder"].values())
    if n_params != VGGT_PARAMS or head["step"] != VGGT_CLI_STEPS:
        fail(f"vggt_cli checkpoint: {n_params} parameters, step {head['step']}")
    del head

    load_s = []
    real_load = cli._load_encoder

    def load_encoder(cfg_, device):
        t = time.perf_counter()
        encoder = real_load(cfg_, device)
        torch.cuda.synchronize(dev)
        load_s.append(time.perf_counter() - t)
        return encoder

    cli._load_encoder = load_encoder
    cuda_lib.reset_launch_counts()
    try:
        rc = cli.main(argv + ["mode=test", f"checkpointing.load={ckpt_path}"])
    finally:
        cli._load_encoder = real_load
    test_counts = cuda_lib.launches()
    targets = sum(len(e["target"]) for e in CLI_INDEX.values())
    # One encoder call a target, all of one signature: the first captures
    # the graph, the others replay it.
    want = {k: 0 for k in test_counts}
    want.update(composite_forward=targets, cumsum_1d=2 * targets,
                encoder_graph_eager=1, encoder_graph_replay=targets - 1)
    scores = test_dir / "scores_all_avg.json"
    if rc != 0 or test_counts != want or not scores.exists():
        fail(f"vggt_cli test: rc {rc}, launches {test_counts} (expected "
             f"{want})")
    val_videos = {str(path.relative_to(root)): gif_frames(path)
                  for path in sorted((out_dir / "validation").glob("*/*.gif"))}
    size = tuple(load_config([repo / VGGT_PRESET], overrides).image_shape)
    if len(val_videos) != 2 * len(list((out_dir / "validation").iterdir())) \
            or not all(1 <= n <= 2 * VAL_VIDEO_FRAMES - 2 and wh == size[::-1]
                       for n, wh in val_videos.values()):
        fail(f"vggt_cli validation videos {val_videos}")
    avg = json.loads(scores.read_text())
    if not all(np.isfinite(v) for k, v in avg.items()
               if isinstance(v, float)):
        fail(f"vggt_cli test: non-finite scores {avg}")
    emit({"phase": "vggt_cli", "preset": VGGT_PRESET, "overrides": overrides,
          "params": n_params, "train_seconds": run["seconds"],
          "losses": losses, "guard": guard,
          "val": {k: v for m in logged.values() for k, v in m.items()
                  if k.startswith("val/")},
          "train_launches": run["launches"],
          "step_launches": run["step_launches"],
          "checkpoint_save": saves[0], "validation_videos_frames_size": val_videos,
          "checkpoint_load_s": load_s, "test_launches": test_counts,
          "averages": avg,
          "request_times": json.loads((test_dir / "benchmark.json").read_text()),
          "peak_memory": json.loads((test_dir / "peak_memory.json").read_text())})
    shutil.rmtree(out_dir)
    return {"vggt_cli_train": run["launches"], "vggt_cli_test": test_counts}


def reference_checkpoint(torch, dev, path: Path, mast3r: bool) -> dict:
    """A seeded random state dict with a full-width DUSt3R checkpoint's key
    names and shapes (`utils/reference_checkpoint.py`), and with `mast3r`
    also MASt3R's local-feature heads, under "model" beside a non-tensor
    entry as MASt3R's file holds them; written to `path`.  Returns its
    parameter count, bytes and seconds."""
    from spfsplatv2_tpu_torch.utils.reference_checkpoint import (
        reference_state_dict,
    )

    t0 = time.perf_counter()
    sd = {k: x.cpu() for k, x in reference_state_dict(
        SEED + (7 if mast3r else 3), mast3r=mast3r, device=dev).items()}
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": sd, "args": "seeded random weights"} if mast3r else sd,
               path)
    return {"params": sum(x.numel() for x in sd.values()),
            "bytes": path.stat().st_size,
            "seconds": time.perf_counter() - t0}


def v1_phases(torch, repo: Path, dev, request, train_batch) -> dict:
    """SPFSplat v1 at full width, phases "v1_request", "v1_train" and
    "v1_distill"; returns each path's launch counts and checks."""
    from spfsplatv2_tpu_torch.config import load_config
    from spfsplatv2_tpu_torch.evaluation.evaluator import (
        EvalConfig,
        evaluate_example,
    )
    from spfsplatv2_tpu_torch.losses.lpips import build_lpips
    from spfsplatv2_tpu_torch.models import get_encoder
    from spfsplatv2_tpu_torch.models.decoder import (
        LONG_CONTEXT_DECODER,
        decode_splatting,
    )
    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.training import loop
    from spfsplatv2_tpu_torch.training.optim import Optimizer
    from spfsplatv2_tpu_torch.training.step import init_train_state

    cfg = load_config([repo / V1_PRESET],
                      ["checkpointing.pretrained_weights=null"])
    hw = tuple(cfg.image_shape)
    t0 = time.perf_counter()
    encoder = get_encoder(cfg.encoder, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in encoder.parameters())
    emit({"phase": "v1_init", "preset": V1_PRESET, "params": n_params,
          "seconds": time.perf_counter() - t0, "image_shape": list(hw),
          "compute_dtype": cfg.encoder.spfsplat.backbone.compute_dtype})

    # ---- v1_request: evaluate_example, 3 requests ----------------------
    dec_cfg, eval_cfg = cfg.decoder, EvalConfig()
    evaluate_example(encoder, request(-4, hw[0]), hw, dec_cfg, eval_cfg,
                     device=dev)
    requests = [request(40 + i, hw[0]) for i in range(V1_REQUESTS)]
    resident = torch.cuda.memory_allocated(dev)
    results, serve_counts = serve_requests(torch, dev, encoder, requests, hw,
                                           dec_cfg, eval_cfg)
    want = {k: 0 for k in serve_counts}
    want.update(composite_forward=V1_REQUESTS, cumsum_1d=2 * V1_REQUESTS)
    if serve_counts != want:
        fail(f"v1_request launch counts {serve_counts}, expected {want}")
    # Each decoder pass writes, a layer, every view's tokens' logits against
    # every view's over all heads (the masked pairs too): (v l)^2 h.
    bb = cfg.encoder.spfsplat.backbone
    tokens = (hw[0] // bb.patch_size) * (hw[1] // bb.patch_size) + 1
    v_cxt = requests[0]["context"]["image"].shape[0]
    v_all = v_cxt + requests[0]["target"]["image"].shape[0]
    per_request = (bb.dec_depth * bb.dec_num_heads * tokens ** 2
                   * (v_cxt ** 2 + v_all ** 2))
    logits = cuda_lib.launch_counts["masked_attn_logits"]
    if logits != V1_REQUESTS * per_request:
        fail(f"v1_request masked logits {logits}, expected "
             f"{V1_REQUESTS} x {per_request}")
    for i, res in enumerate(results):
        vals = [*res["psnr"], *res["ssim"], *res["pose_rot_err_deg"],
                *res["pose_transl_err_deg"]]
        if tuple(res["rendered"].shape) != (1, *hw, 3) or not bool(
                torch.isfinite(res["rendered"]).all()) or not all(
                v == v and abs(v) != float("inf") for v in vals):
            fail(f"v1 request {i}: rendered {tuple(res['rendered'].shape)}, "
                 f"metrics {vals}")
    # The first request's render through K1 and K3 against their plain
    # versions on the card, on the encoder's own Gaussians and pose.
    c, t = requests[0]["context"], requests[0]["target"]
    with torch.no_grad():
        out = encoder(c["image"][None], c["intrinsics"][None], t["image"][None],
                      t["intrinsics"][None])
    for key in ("pts3d", "extrinsics_c", "extrinsics_cwt", "depths"):
        if not bool(torch.isfinite(out[key]).all()):
            fail(f"v1 encoder output {key} is not finite")
    cams_args = (out["extrinsics_cwt"][:, 2:], t["intrinsics"][None],
                 t["near"][None], t["far"][None], hw, dec_cfg)
    render_check, scan_ns = render_vs_plain(
        torch, decode_splatting, cams_args, out["gaussians"], "v1 256^2")
    with torch.no_grad():
        alpha = decode_splatting(out["gaussians"], *cams_args).alpha
    if not float(alpha.mean()) > 0.0:
        fail("v1 request 0 renders nothing")
    emit({"phase": "v1_request", "requests": V1_REQUESTS,
          "launches": serve_counts, "masked_logits": logits,
          "encoder_ms": [r["times"]["encoder"]["mean_s"] * 1e3 for r in results],
          "decoder_ms": [r["times"]["decoder"]["mean_s"] * 1e3 for r in results],
          "peak_bytes": [r["peak_bytes"] for r in results],
          "resident_bytes": resident,
          "psnr": [r["psnr"][0] for r in results],
          "dropped_entries": [r["dropped_entries"] for r in results],
          "alpha_mean": float(alpha.mean()),
          "points_in_front": float((out["depths"] > 0).float().mean()),
          "pose_t_c": out["extrinsics_c"][0, :, :3, 3].tolist(),
          "pose_t_cwt": out["extrinsics_cwt"][0, :, :3, 3].tolist(),
          "render_vs_plain": render_check, "k3_exact_on_inputs_n": scan_ns})
    del out, results
    torch.cuda.empty_cache()

    # ---- v1_request_1024: one request at 1024^2 ------------------------
    # 4,097 tokens a view: every self-attention takes K5, and each decoder
    # pass's cross-attention (8,194 and 12,291 keys) the view-masked
    # kernel, which writes no dense logits.
    long_size = (HW_LONG, HW_LONG)
    evaluate_example(encoder, request(-5, HW_LONG), long_size,
                     LONG_CONTEXT_DECODER, eval_cfg, device=dev)
    long_results, long_counts = serve_requests(
        torch, dev, encoder, [request(45, HW_LONG)], long_size,
        LONG_CONTEXT_DECODER, eval_cfg)
    long_logits = cuda_lib.launch_counts["masked_attn_logits"]
    want = {k: 0 for k in long_counts}
    want.update(flash_forward=V1_1024_K5, flash_view_masked=V1_1024_VIEW_MASKED,
                composite_forward=1, cumsum_1d=2)
    res = long_results[0]
    if long_counts != want or long_logits != 0:
        fail(f"v1_request_1024 launch counts {long_counts} and masked "
             f"logits {long_logits}, expected {want} and 0")
    if not bool(torch.isfinite(res["rendered"]).all()) or not all(
            math.isfinite(v) for v in [*res["psnr"], *res["pose_rot_err_deg"]]):
        fail("v1_request_1024: non-finite output")
    emit({"phase": "v1_request_1024", "launches": long_counts,
          "masked_logits": long_logits,
          "encoder_ms": res["times"]["encoder"]["mean_s"] * 1e3,
          "decoder_ms": res["times"]["decoder"]["mean_s"] * 1e3,
          "peak_bytes": res["peak_bytes"], "psnr": res["psnr"]})
    del long_results, res
    torch.cuda.empty_cache()

    # ---- v1_train: make_train_step at b = 12 ---------------------------
    lpips = build_lpips(seed=SEED, device=dev)
    encoder.train()
    state = init_train_state(encoder, Optimizer(cfg.optimizer,
                                                encoder.named_parameters()))
    batches = [train_batch(50 + i, cfg.trainer.batch_size, hw[0])
               for i in range(V1_STEPS + V1_DISTILL_STEPS)]
    run = train_steps(torch, dev, state, cfg, hw, lpips, batches[:V1_STEPS],
                      "v1_train")
    if not all("loss/reproj_c2_only" in st["metrics"] for st in run["steps"]):
        fail("v1_train: a step lacks loss/reproj_c2_only")
    for st in run["steps"]:
        emit({"phase": "v1_train_step", "batch": run["batch"],
              "microbatch": run["microbatch"], **st})
    emit({"phase": "v1_train", **train_summary(run)})

    # ---- v1_distill: the full-width DUSt3R teacher --------------------
    weights = repo / "build" / "v1" / "dust3r.pth"
    written = reference_checkpoint(torch, dev, weights, mast3r=False)
    t0 = time.perf_counter()
    teacher = loop.load_distiller_params(str(weights), SEED, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    weights.unlink()
    frozen = [p.detach().clone() for p in teacher.parameters()]
    drun = train_steps(torch, dev, state, cfg, hw, lpips, batches[V1_STEPS:],
                       "v1_distill", microbatch=run["microbatch"],
                       distiller=teacher)
    losses = [st["metrics"].get("loss/distillation", float("nan"))
              for st in drun["steps"]]
    # Above 0: the teacher's confidence clears DUSt3R's bar of 3 somewhere.
    if not all(math.isfinite(v) and v > 0 for v in losses):
        fail(f"v1_distill: loss/distillation {losses}")
    if any(p.requires_grad or p.grad is not None for p in teacher.parameters()) \
            or not all(torch.equal(a, p) for a, p in zip(frozen,
                                                         teacher.parameters())):
        fail("v1_distill: the teacher changed or took a gradient")
    for st in drun["steps"]:
        emit({"phase": "v1_distill_step", "batch": drun["batch"],
              "microbatch": drun["microbatch"], **st})
    emit({"phase": "v1_distill", **train_summary(drun),
          "teacher_params": sum(p.numel() for p in teacher.parameters()),
          "state_dict": written, "load_and_convert_s": load_s,
          "loss_distillation": losses, "teacher_unchanged": True})
    return {"serve": serve_counts, "serve_1024": long_counts,
            "train": run["launches"],
            "distill": drun["launches"], "render_check": render_check,
            "scan_ns": scan_ns, "k2_check": run["k2_vs_plain"],
            "k2_check_distill": drun["k2_vs_plain"]}


def v1_cli_phase(torch, repo: Path, dev) -> dict:
    """Phase "v1_cli": the command line on the v1 preset, mode=train for 2
    steps on phase 14's synthetic chunks from a MASt3R-keyed state dict
    (`checkpointing.pretrained_weights`), then mode=test from the saved
    checkpoint; returns each call's kernel launch counts."""
    import numpy as np

    from spfsplatv2_tpu_torch import main as cli
    from spfsplatv2_tpu_torch.config import load_config
    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.training import loop

    root = repo / "build" / "cli"
    out_dir, test_dir = root / "v1_out", root / "v1_test_out"
    weights = repo / "build" / "v1" / "mast3r.pth"
    written = reference_checkpoint(torch, dev, weights, mast3r=True)
    overrides = [f"dataset.roots=[{root}]", f"trainer.max_steps={V1_CLI_STEPS}",
                 "trainer.val_check_interval=1",
                 f"checkpointing.pretrained_weights={weights}",
                 f"output_dir={out_dir}", "checkpointing.every_n_train_steps=0",
                 "train.print_log_every_n_steps=1",
                 f"evaluation_sampler.index_path={root / 'index.json'}",
                 f"test.output_path={test_dir}", "test.save_image=false"]
    argv = ["--config", str(repo / V1_PRESET), *overrides]
    batch = load_config([repo / V1_PRESET], overrides).trainer.batch_size
    loads = []

    def load_pretrained_weights(real):
        def load(encoder, encoder_cfg, path):
            t = time.perf_counter()
            encoder = real(encoder, encoder_cfg, path)
            torch.cuda.synchronize(dev)
            loads.append(time.perf_counter() - t)
            return encoder

        return load

    run = cli_train(torch, dev, argv,
                    {"load_pretrained_weights": load_pretrained_weights})
    weights.unlink()
    logged = run["logged"]
    losses = [m["loss/total"] for s, m in sorted(logged.items())
              if "loss/total" in m]
    c2_only = [m.get("loss/reproj_c2_only") for s, m in sorted(logged.items())
               if "loss/total" in m]
    if run["rc"] != 0 or len(loads) != 1 or len(losses) != V1_CLI_STEPS \
            or not all(np.isfinite(losses)) \
            or not all(v is not None and np.isfinite(v) for v in c2_only):
        fail(f"v1_cli train: rc {run['rc']}, {len(loads)} weight loads, "
             f"losses {losses}, reproj_c2_only {c2_only}")
    (guard,) = run["guards"]
    want = {k: 0 for k in run["launches"]}
    want.update(composite_forward=batch, composite_backward=batch,
                cumsum_1d=2 * batch)
    if run["step_launches"] != [want] * V1_CLI_STEPS:
        fail(f"v1_cli steps' launch counts {run['step_launches']}, expected "
             f"{want} each")
    ckpt_path = out_dir / "checkpoints" / "step_-1"
    head = loop.load_checkpoint(ckpt_path)
    n_params = sum(t.numel() for t in head["encoder"].values())
    if head["step"] != V1_CLI_STEPS:
        fail(f"v1_cli checkpoint at step {head['step']}")
    del head

    cuda_lib.reset_launch_counts()
    rc = cli.main(argv + ["mode=test", f"checkpointing.load={ckpt_path}"])
    test_counts = cuda_lib.launches()
    targets = sum(len(e["target"]) for e in CLI_INDEX.values())
    want = {k: 0 for k in test_counts}
    want.update(composite_forward=targets, cumsum_1d=2 * targets)
    scores = test_dir / "scores_all_avg.json"
    if rc != 0 or test_counts != want or not scores.exists():
        fail(f"v1_cli test: rc {rc}, launches {test_counts} (expected {want})")
    avg = json.loads(scores.read_text())
    if not all(np.isfinite(v) for k, v in avg.items() if isinstance(v, float)):
        fail(f"v1_cli test: non-finite scores {avg}")
    emit({"phase": "v1_cli", "preset": V1_PRESET, "overrides": overrides,
          "params": n_params, "pretrained_state_dict": written,
          "pretrained_load_s": loads, "train_seconds": run["seconds"],
          "losses": losses, "reproj_c2_only": c2_only, "guard": guard,
          "val": {k: v for m in logged.values() for k, v in m.items()
                  if k.startswith("val/")},
          "train_launches": run["launches"],
          "step_launches": run["step_launches"],
          "test_launches": test_counts, "averages": avg,
          "request_times": json.loads((test_dir / "benchmark.json").read_text()),
          "peak_memory": json.loads((test_dir / "peak_memory.json").read_text())})
    shutil.rmtree(out_dir)
    return {"v1_cli_train": run["launches"], "v1_cli_test": test_counts}


def demo_phase(torch, repo: Path, dev) -> dict:
    """Phase "demo_1024": `demo.run_demo` in process on two seeded photos
    at 1024^2 from a seeded init (view 1 placed DEMO_BASELINE to the
    side, so that the video moves), with the launch counts read around
    exactly that call; its outputs checked, its first video frame's
    render held against the same render through the plain versions of K1
    and K3 on the card; returns the counts and that check."""
    import numpy as np
    from PIL import Image

    from spfsplatv2_tpu_torch import demo
    from spfsplatv2_tpu_torch.evaluation import video
    from spfsplatv2_tpu_torch.models.decoder import decode_splatting
    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.utils import ply_export

    t_phase = time.perf_counter()
    root = repo / "build" / "demo"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    h, w = DEMO_PHOTO_HW
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    paths = []
    for i in range(2):
        img = np.stack([xx + 0.1 * i, yy, 0.5 + 0.4 * np.sin(20 * xx * yy)], -1)
        img = np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1)
        paths.append(str(root / f"photo_{i}.png"))
        Image.fromarray((img * 255).astype(np.uint8)).save(paths[-1])

    timer, recorded = Timer(torch, dev), []
    real = {"build_encoder": demo.build_encoder,
            "decode_splatting": video.decode_splatting,
            "save_video": video.save_video,
            "export_ply": ply_export.export_ply}

    def build_encoder(*args, **kwargs):
        encoder = timer.wrap("encoder_init", real["build_encoder"])(*args,
                                                                    **kwargs)
        with torch.no_grad():
            encoder.pose_head2.fc_t.bias[0] += DEMO_BASELINE
        encoder.forward = timer.wrap("encoder", encoder.forward)
        return encoder

    def decode(*args):
        recorded.append(args)
        return timer.wrap("render", real["decode_splatting"])(*args)

    demo.build_encoder, video.decode_splatting = build_encoder, decode
    video.save_video = timer.wrap("gif_write", real["save_video"])
    ply_export.export_ply = timer.wrap("ply_write", real["export_ply"])
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = demo.run_demo(paths, None, str(root / "out"), DEMO_SIZE,
                               device=dev)
    finally:
        demo.build_encoder = real["build_encoder"]
        video.decode_splatting = real["decode_splatting"]
        video.save_video = real["save_video"]
        ply_export.export_ply = real["export_ply"]
    run_s = time.perf_counter() - t0
    counts = cuda_lib.launches()
    peak = torch.cuda.max_memory_allocated(dev)

    # Two encoder passes of one signature (the demo's, then the video's on
    # the context): the first runs eagerly and is captured, 48 K5 forward
    # and 24 view-masked launches each, and the second replays the graph;
    # one K1 and two K3 a video frame.
    on_path = {"flash_forward": 2 * K5_PER_PASS,
               "flash_view_masked": 2 * VIEW_MASKED_PER_PASS,
               "encoder_graph_eager": 1,
               "encoder_graph_replay": 1,
               "composite_forward": DEMO_FRAMES, "cumsum_1d": 2 * DEMO_FRAMES}
    off_path = {k: v for k, v in counts.items() if k not in on_path}
    if {k: counts.get(k, 0) for k in on_path} != on_path or any(
            off_path.values()):
        fail(f"demo_1024 launch counts {counts}, expected {on_path} and 0 "
             "elsewhere")
    poses = np.asarray(result["poses"])
    if poses.shape != (2, 4, 4) or not np.isfinite(poses).all():
        fail(f"demo_1024 poses: shape {poses.shape}, finite "
             f"{np.isfinite(poses).all()}")
    g = 2 * DEMO_SIZE * DEMO_SIZE
    ply_path = root / "out" / "gaussians.ply"
    ply = ply_export.load_ply(ply_path)
    body = g * PLY_FLOATS * 4
    header = len(ply_export.ply_header(g))
    if ply["means"].shape != (g, 3) or ply_path.stat().st_size != header + body \
            or not all(np.isfinite(c).all() for c in ply.values()):
        fail(f"demo_1024 PLY: {ply['means'].shape[0]} vertices, "
             f"{ply_path.stat().st_size} bytes (expected {header} + {body})")
    gif = gif_frames(root / "out" / "interpolation.gif")
    if gif != (2 * DEMO_FRAMES - 2, (DEMO_SIZE, DEMO_SIZE)):
        fail(f"demo_1024 GIF (frames, size) {gif}")
    (gaussians, extr, intr, near, far, shape, cfg), = recorded
    # The exact depth rank (g - 1 < 2^21) and the tile id (up to 4096 + 1
    # at 1024^2) overflow the 31-bit key: the quantized key.
    key_bits = (g - 1).bit_length() + ((DEMO_SIZE // 16) ** 2 + 1).bit_length()
    want_key = "quantized" if key_bits > 31 else "rank"
    if cfg.rasterizer.depth_key != want_key or extr.shape[1] != DEMO_FRAMES:
        fail(f"demo_1024 rendered {extr.shape[1]} frames with depth key "
             f"{cfg.rasterizer.depth_key!r}")
    # The first frame through K1 and K3 against their plain versions.
    render_check, scan_ns = render_vs_plain(
        torch, decode_splatting,
        (extr[:, :1], intr[:, :1], near[:, :1], far[:, :1], shape, cfg),
        gaussians, "demo 1024^2 frame 0")
    del recorded, gaussians
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "demo_1024", "photos_hw": list(DEMO_PHOTO_HW),
          "image_size": DEMO_SIZE, "checkpoint": None,
          "launches": counts, "launches_expected_on_path": on_path,
          "launches_off_path_all_zero": off_path,
          "poses": poses.tolist(), "ply_vertices": ply["means"].shape[0],
          "ply_bytes": header + body, "gif_frames_size": gif,
          "depth_key": cfg.rasterizer.depth_key,
          "frame0_render_vs_plain": render_check, "k3_exact_on_inputs_n": scan_ns,
          "encoder_init_s": timer.spans["encoder_init"],
          "encoder_pass_ms": [t * 1e3 for t in timer.spans["encoder"]],
          "render_60_frames_ms": timer.spans["render"][0] * 1e3,
          "ply_write_s": timer.spans["ply_write"][0],
          "gif_write_s": timer.spans["gif_write"][0],
          "run_demo_s": run_s, "peak_bytes": peak,
          "seconds": time.perf_counter() - t_phase})
    return {"counts": counts, "render_check": render_check}


def cli_phases(torch, repo: Path, dev) -> dict:
    """The command line in process, phases "cli_data", "cli_train",
    "cli_guard", "cli_test" and "cli_eval_pose"; returns each call's
    kernel launch counts."""
    import numpy as np
    from PIL import Image

    from spfsplatv2_tpu_torch import main as cli
    from spfsplatv2_tpu_torch.config import load_config
    from spfsplatv2_tpu_torch.data.synthetic import write_synthetic_dataset
    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.training import loop
    from spfsplatv2_tpu_torch.utils import pnp, visualization

    root = repo / "build" / "cli"
    shutil.rmtree(root, ignore_errors=True)
    out_dir, test_dir = root / "out", root / "test_out"

    # ---- 14. cli_data ---------------------------------------------------
    t0 = time.perf_counter()
    for stage, (scenes, frames) in CLI_SCENES.items():
        write_synthetic_dataset(root, scenes, frames, (360, 640), stage,
                                processes=min(8, os.cpu_count() or 1))
    index = root / "index.json"
    index.write_text(json.dumps(CLI_INDEX))
    emit({"phase": "cli_data", "seconds": time.perf_counter() - t0,
          "scenes_frames": CLI_SCENES, "image_hw": [360, 640],
          "chunk_bytes": {s: (root / s / "000000.torch").stat().st_size
                          for s in CLI_SCENES}})

    overrides = [f"dataset.roots=[{root}]", f"trainer.max_steps={CLI_STEPS}",
                 f"trainer.val_check_interval={CLI_VAL_EVERY}",
                 "checkpointing.pretrained_weights=null",
                 f"output_dir={out_dir}",
                 "checkpointing.every_n_train_steps=0",
                 "train.print_log_every_n_steps=1",
                 f"evaluation_sampler.index_path={index}",
                 f"test.output_path={test_dir}"]
    argv = ["--config", str(repo / CLI_PRESET), *overrides]
    cfg = load_config([repo / CLI_PRESET], overrides)
    batch = cfg.trainer.batch_size

    # ---- 15. cli_train: python -m spfsplatv2_tpu_torch.main (mode=train)
    step_ms, logged, guards, saves = [], {}, [], []
    real = {k: getattr(loop, k) for k in ("make_train_step", "run_training",
                                          "save_checkpoint")}

    def make_train_step(*args, **kwargs):
        step = real["make_train_step"](*args, **kwargs)

        def timed(state, batch_):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            out = step(state, batch_)
            torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t) * 1e3)
            return out

        return timed

    def run_training(cfg_, log_fn=None, **kwargs):
        def log(step, metrics):
            logged.setdefault(step, {}).update(metrics)
            log_fn(step, metrics)

        result = real["run_training"](cfg_, log_fn=log, **kwargs)
        guards.append(result["guard"])
        return result

    def save_checkpoint(ckpt_dir, state, step):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        path = real["save_checkpoint"](ckpt_dir, state, step)
        saves.append({"step": step, "seconds": time.perf_counter() - t,
                      "bytes": path.stat().st_size})
        return path

    for name, fn in (("make_train_step", make_train_step),
                     ("run_training", run_training),
                     ("save_checkpoint", save_checkpoint)):
        setattr(loop, name, fn)
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = run_cli(cli, argv)
    finally:
        for name, fn in real.items():
            setattr(loop, name, fn)
    train_s = time.perf_counter() - t0
    train_counts = cuda_lib.launches()
    gc.collect()
    torch.cuda.empty_cache()
    if rc != 0 or len(step_ms) != CLI_STEPS or len(saves) != 1:
        fail(f"cli_train: rc {rc}, {len(step_ms)} steps, {len(saves)} saves")
    (guard,) = guards
    probed = sum(p["microbatch"] for p in guard["probes"])
    val_steps = [s for s in range(1, CLI_STEPS) if s % CLI_VAL_EVERY == 0]
    renders = CLI_STEPS * batch + probed
    # A validation renders its 2 context views and target, then each
    # video's frames.
    val_renders = (3 + 2 * VAL_VIDEO_FRAMES) * len(val_steps)
    want = {"composite_forward": renders + val_renders,
            "composite_backward": renders,
            "cumsum_1d": 2 * (renders + val_renders)}
    want = {k: want.get(k, 0) for k in train_counts}
    if train_counts != want:
        fail(f"cli_train launch counts {train_counts}, expected {want}")
    losses = [m["loss/total"] for s, m in sorted(logged.items())
              if "loss/total" in m]
    if len(losses) != CLI_STEPS or not all(np.isfinite(losses)):
        fail(f"cli_train losses {losses}")
    ckpt_path = out_dir / "checkpoints" / "step_-1"
    head = loop.load_checkpoint(ckpt_path)
    if head["step"] != CLI_STEPS or head["count"] + head["skipped_count"] != CLI_STEPS:
        fail(f"cli_train checkpoint at step {head['step']}, count "
             f"{head['count']}, skipped {head['skipped_count']}")
    n_params = sum(t.numel() for t in head["encoder"].values())
    del head
    val_videos = {}
    for s in val_steps:
        for name in ("interpolation", "wobble"):
            path = out_dir / "validation" / f"step_{s}" / f"{name}.gif"
            val_videos[str(path.relative_to(root))] = got = gif_frames(path)
            if not 1 <= got[0] <= 2 * VAL_VIDEO_FRAMES - 2 or \
                    got[1] != tuple(cfg.image_shape)[::-1]:
                fail(f"cli_train: {path} has (frames, size) {got}")
    emit({"phase": "cli_train", "preset": CLI_PRESET, "overrides": overrides,
          "params": n_params, "batch": batch, "steps": CLI_STEPS,
          "seconds": train_s, "step_ms": step_ms,
          "data_wait_ms": [logged[s]["time/data_wait_ms"] for s in sorted(logged)
                           if "time/data_wait_ms" in logged[s]],
          "losses": losses,
          "val": {k: v for m in logged.values() for k, v in m.items()
                  if k.startswith("val/")},
          "guard": guard, "launches": train_counts, "expected_launches": want,
          "validation_videos_frames_size": val_videos,
          "checkpoint_save": saves[0]})

    # ---- 16. cli_guard: a budget below the step's peak halves ----------
    low = load_config([repo / CLI_PRESET], overrides + [
        f"trainer.hbm_budget_gb={CLI_LOW_BUDGET_GB}"])
    cuda_lib.reset_launch_counts()
    result = loop.run_training(low, max_steps=0, device=dev)
    guard_counts = cuda_lib.launches()
    low_guard = result["guard"]
    took = (result["state"].step, result["state"].optimizer.count)
    del result
    gc.collect()
    torch.cuda.empty_cache()
    probed = sum(p["microbatch"] for p in low_guard["probes"])
    want = {k: 0 for k in guard_counts}
    want.update(composite_forward=probed, composite_backward=probed,
                cumsum_1d=2 * probed)
    if not low_guard["microbatch"] < batch or took != (0, 0) or guard_counts != want:
        fail(f"cli_guard: microbatch {low_guard['microbatch']}, steps and "
             f"updates {took}, launches {guard_counts} (expected {want})")
    emit({"phase": "cli_guard", "budget_gb": CLI_LOW_BUDGET_GB,
          "guard": low_guard, "launches": guard_counts})

    # ---- 17. cli_test: mode=test, images and videos saved, seeded LPIPS -
    saved = []
    real_save_image, real_load = visualization.save_image, cli._load_encoder

    def save_image(image, path):
        saved.append((Path(path), np.array(image)))
        real_save_image(image, path)

    load_s = []

    def load_encoder(cfg_, device):
        t = time.perf_counter()
        encoder = real_load(cfg_, device)
        torch.cuda.synchronize(dev)
        load_s.append(time.perf_counter() - t)
        return encoder

    visualization.save_image, cli._load_encoder = save_image, load_encoder
    cuda_lib.reset_launch_counts()
    try:
        rc = cli.main(argv + ["mode=test", f"checkpointing.load={ckpt_path}",
                              "test.save_image=true", "test.save_video=true"])
    finally:
        visualization.save_image, cli._load_encoder = real_save_image, real_load
    test_counts = cuda_lib.launches()
    targets = sum(len(e["target"]) for e in CLI_INDEX.values())
    # One encoder call a target, all of one signature: the first captures
    # the graph, the others replay it.
    want = {k: 0 for k in test_counts}
    want.update(composite_forward=targets, cumsum_1d=2 * targets,
                encoder_graph_eager=1, encoder_graph_replay=targets - 1)
    artifacts = ["scores_all.json", "scores_all_avg.json",
                 "scores_sub_avg.json", "benchmark.json", "peak_memory.json"]
    missing = [a for a in artifacts if not (test_dir / a).exists()]
    if rc != 0 or missing or test_counts != want or len(saved) != targets:
        fail(f"cli_test: rc {rc}, missing {missing}, launches {test_counts} "
             f"(expected {want}), {len(saved)} images")
    # The first scene's first saved frame, read back, against the writer's
    # rule on the rendered frame it was given.
    path, frame = saved[0]
    png = np.asarray(Image.open(path))
    expect = np.clip(frame * 255, 0, 255).astype(np.uint8)
    if path.parent.parent.name != "scene_000" or not np.array_equal(png, expect):
        fail(f"cli_test: {path} differs from its frame")
    # Each scene's target frames as one GIF, named by its context indices.
    videos = {}
    for scene, e in CLI_INDEX.items():
        name = f"{scene}_frame_{'_'.join(map(str, e['context']))}.gif"
        videos[name] = got = gif_frames(test_dir / "video" / name)
        if not 1 <= got[0] <= len(e["target"]) or \
                got[1] != tuple(cfg.image_shape)[::-1]:
            fail(f"cli_test: video {name} has (frames, size) {got}")
    if sorted(p.name for p in (test_dir / "video").iterdir()) != sorted(videos):
        fail(f"cli_test: videos {sorted((test_dir / 'video').iterdir())}")
    avg = json.loads((test_dir / "scores_all_avg.json").read_text())
    bench = json.loads((test_dir / "benchmark.json").read_text())
    emit({"phase": "cli_test", "scenes": len(CLI_INDEX), "targets": targets,
          "launches": test_counts, "png_equals_frame": str(path.relative_to(root)),
          "videos_frames_size": videos,
          "averages": avg, "request_times": bench,
          "peak_memory": json.loads((test_dir / "peak_memory.json").read_text()),
          "checkpoint_load_s": load_s})

    # ---- 18. cli_eval_pose: mode=eval_pose -------------------------------
    cuda_lib.reset_launch_counts()
    rc = cli.main(argv + ["mode=eval_pose", f"checkpointing.load={ckpt_path}"])
    pose_counts = cuda_lib.launches()
    pose_file = test_dir / "pose_eval.json"
    # One encoder call a scene, on its two context views.
    want = {k: 0 for k in pose_counts}
    want.update(encoder_graph_eager=1, encoder_graph_replay=len(CLI_INDEX) - 1)
    if rc != 0 or not pose_file.exists() or pose_counts != want:
        fail(f"cli_eval_pose: rc {rc}, launches {pose_counts}, expected "
             f"{want}")
    emit({"phase": "cli_eval_pose", "launches": pose_counts,
          "summary": json.loads(pose_file.read_text()),
          "pnp_library": str(pnp.native_library().path.relative_to(repo)),
          "pnp_build_seconds": pnp.native_library().build_seconds})
    # The synthetic chunks stay for phase "vggt_cli"; the checkpoints go.
    shutil.rmtree(out_dir)
    return {"cli_train_3_steps": train_counts, "cli_guard": guard_counts,
            "cli_test": test_counts, "cli_eval_pose": pose_counts}


GAUSSIAN_FIELDS = ("means", "covariances", "harmonics", "opacities")


def seeded_batch(torch, dev, seed: int, b: int, size: int,
                 ctx_offsets=(0.0, 0.2), tgt_offsets=(0.1,)) -> dict:
    """A train batch of `b` seeded scenes at size^2: per side, cameras at
    these x offsets (jittered), random images, near 0.1, far 100."""
    r = torch.Generator(device=dev).manual_seed(seed)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], device=dev)

    def side(offsets):
        v = len(offsets)
        c2w = torch.eye(4, device=dev).repeat(b, v, 1, 1)
        c2w[..., 0, 3] = torch.tensor(offsets, device=dev)
        c2w[..., :3, 3] += 0.02 * torch.randn(b, v, 3, generator=r, device=dev)
        return {"image": torch.rand(b, v, size, size, 3, generator=r,
                                    device=dev),
                "intrinsics": k.expand(b, v, 3, 3).clone(), "extrinsics": c2w,
                "near": torch.full((b, v), 0.1, device=dev),
                "far": torch.full((b, v), 100.0, device=dev)}

    return {"context": side(list(ctx_offsets)),
            "target": side(list(tgt_offsets))}


def seeded_request(torch, dev, seed: int, size: int, ctx_offsets=(0.0, 0.2),
                   tgt_offset: float = 0.1) -> dict:
    """One seeded request at size^2: context views at these x offsets and
    one target, random images, near 1, far 100."""
    r = torch.Generator(device=dev).manual_seed(seed)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]],
                     device=dev).expand(1, 3, 3)

    def view(offset):
        c2w = torch.eye(4, device=dev)
        c2w[0, 3] = offset
        return {"image": torch.rand(1, size, size, 3, generator=r, device=dev),
                "intrinsics": k.clone(), "extrinsics": c2w[None],
                "near": torch.ones(1, device=dev),
                "far": torch.full((1,), 100.0, device=dev)}

    views = [view(o) for o in ctx_offsets]
    tgt = view(tgt_offset)
    ctx = {key: torch.cat([v[key] for v in views]) for key in views[0]}
    ctx["overlap"] = 0.5
    return {"scene": f"request_{seed}", "context": ctx, "target": tgt}


def capture_grads(torch, optimizer) -> list:
    """Wrap `optimizer.step` to keep, at each call, the gradient it is
    handed before its clip: every trainable parameter's, flattened in the
    optimizer's order, on the host."""
    seen = []
    real = optimizer.step

    def step():
        seen.append(torch.cat([p.grad.reshape(-1) for p in optimizer.params])
                    .cpu())
        return real()

    optimizer.step = step
    return seen


def join_gloo(torch, rank: int, world: int, store: str):
    """This process as rank `rank` of a gloo group over a file store, its
    tensors on the one card; returns torch.distributed."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    return dist


def same_on_every_rank(torch, dist, flat) -> bool:
    """Whether rank 1's `flat` equals this rank's bit for bit (rank 1's
    copy is broadcast; on rank 1 itself, trivially true)."""
    other = flat.clone() if dist.get_rank() == 1 else torch.empty_like(flat)
    dist.broadcast(other, src=1)
    return bool(torch.equal(flat, other))


def ddp_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of "ddp_2rank" (started by torch.multiprocessing.spawn):
    the full-width flagship at its seeded init and the re10k recipe,
    `make_train_step(mesh=make_mesh(n_data=world))` on this rank's part
    of the parent's b = TRAIN_BATCH batch.  Writes its numbers to
    `rank<r>.json`; rank 0 also writes its all-reduced gradient (before
    the clip) and its parameters after the update."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spfsplatv2_tpu_torch.losses.lpips import build_lpips
    from spfsplatv2_tpu_torch.models import build_encoder
    from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config
    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.parallel import make_mesh, shard_batch
    from spfsplatv2_tpu_torch.parallel.mesh import audit_overlap
    from spfsplatv2_tpu_torch.training.optim import Optimizer, OptimizerConfig
    from spfsplatv2_tpu_torch.training.step import (
        LossConfig,
        init_train_state,
        make_train_step,
    )

    dist = join_gloo(torch, rank, world, store)
    dev = torch.device("cuda", 0)
    out = Path(out_dir)
    try:
        encoder = build_encoder(SPFSplatV2Config(), seed=SEED, device=dev)
        optimizer = Optimizer(OptimizerConfig(), encoder.named_parameters())
        grads = capture_grads(torch, optimizer)
        state = init_train_state(encoder, optimizer)
        mesh = make_mesh(n_data=world)
        step = make_train_step(encoder, optimizer, (FLAGSHIP_HW, FLAGSHIP_HW),
                               lpips=build_lpips(seed=SEED, device=dev),
                               loss_cfg=LossConfig(),
                               microbatch=TRAIN_BATCH // world, mesh=mesh)
        batches = [shard_batch(seeded_batch(torch, dev, seed, TRAIN_BATCH,
                                            FLAGSHIP_HW), mesh)
                   for seed in (2100, 2101)]
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_lib.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, batches[0])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = cuda_lib.launches()
        audit = json.loads(json.dumps(step.audit.counts))
        peak = torch.cuda.max_memory_allocated(dev)
        flat = torch.cat([p.detach().reshape(-1) for p in optimizer.params])
        identical = same_on_every_rank(torch, dist, flat)
        if rank == 0:
            torch.save(grads[0], out / "grad.pt")
            torch.save(flat.cpu(), out / "params.pt")
        del flat
        # A second step under the profiler (host events): did a bucket's
        # all-reduce start before the backward's last autograd node ended?
        # (DDP sizes its buckets after the first step.)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, batches[1])
            torch.cuda.synchronize()
        overlap = audit_overlap(prof.events())
        audit2 = json.loads(json.dumps(step.audit.counts))
        result = {"rank": rank, "loss": metrics["loss/total"],
                  "metrics": metrics, "step_ms": ms, "launches": counts,
                  "all_reduce": audit["all-reduce"],
                  "all_reduce_step2": audit2["all-reduce"],
                  "trainable_f32_bytes": sum(p.numel() * 4
                                             for p in optimizer.params),
                  "peak_bytes": peak, "replicas_bit_identical": identical,
                  "overlap": overlap}
        (out / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def tile_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of "tile_shard_1024": `render_tile_sharded` of the parent's
    1024^2 Gaussians on a (1, world) mesh, rows [rank * 1024 / world, ...),
    then the backward of the parent's weighted sum of the outputs.  Rank
    0 writes the gathered image and the Gaussians' summed gradients."""
    import torch

    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.parallel import make_mesh
    from spfsplatv2_tpu_torch.parallel.raster_shard import render_tile_sharded

    dist = join_gloo(torch, rank, world, store)
    dev = torch.device("cuda", 0)
    out = Path(out_dir)
    try:
        data = torch.load(out / "tile_in.pt", map_location=dev,
                          weights_only=False)
        mesh = make_mesh(n_data=1, n_tile=world)
        leaves = [data[k].clone().requires_grad_(True) for k in GAUSSIAN_FIELDS]
        cuda_lib.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = render_tile_sharded(
            mesh, data["extrinsics"], data["intrinsics"], data["near"],
            data["far"], data["image_shape"], data["background"], *leaves,
            cfg=data["cfg"])
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        fwd_counts = cuda_lib.launches()
        sum((o * w).sum() for o, w in zip((res.color, res.depth, res.alpha),
                                          data["weights"])).backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = cuda_lib.launches()
        flat = torch.cat([t.grad.reshape(-1) for t in leaves])
        identical = same_on_every_rank(torch, dist, flat)
        if rank == 0:
            torch.save({"color": res.color.detach().cpu(),
                        "depth": res.depth.detach().cpu(),
                        "alpha": res.alpha.detach().cpu(),
                        "grads": [t.grad.cpu() for t in leaves]},
                       out / "tile_out.pt")
        (out / f"rank{rank}.json").write_text(json.dumps({
            "rank": rank, "forward_ms": fwd_ms, "forward_backward_ms": ms,
            "forward_launches": fwd_counts, "launches": counts,
            "grads_bit_identical_across_ranks": identical,
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, out: Path) -> list:
    """`fn(rank, DDP_WORLD, store, out)` in DDP_WORLD spawned processes,
    joined (a child's exception is raised here); -> their results,
    `<out>/rank<r>.json`."""
    import torch.multiprocessing as mp

    store = out / "store"
    store.unlink(missing_ok=True)
    mp.spawn(fn, args=(DDP_WORLD, str(store), str(out)), nprocs=DDP_WORLD)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(DDP_WORLD)]


def images_close(actual, desired, atol: float, share: float,
                 hard: float) -> dict:
    """tests/test_rasterizer.py's image bound: `share` of the pixels
    within `atol` and every pixel within `hard`."""
    diff = (actual.float() - desired.float()).abs()
    within = float((diff <= atol).float().mean())
    return {"max_abs_err": float(diff.max()), "share_within": within,
            "ok": float(diff.max()) <= hard and within >= share}


def vggt_10view_phase(torch, repo: Path, dev) -> dict:
    """Phase "vggt_10view": the 10-view VGGT preset at full width, one
    request (10 context views and a target at 224^2) through
    `evaluate_example` and one train step at the preset's b = 2 with its
    context-view dropout, launch counts read around each; and
    `utils/drawing.py:draw_cameras` of the request's 11 predicted poses
    on the card against the same call on the CPU."""
    import numpy as np

    from spfsplatv2_tpu_torch.config import load_config
    from spfsplatv2_tpu_torch.evaluation.evaluator import (
        EvalConfig,
        evaluate_example,
    )
    from spfsplatv2_tpu_torch.losses.lpips import build_lpips
    from spfsplatv2_tpu_torch.models import get_encoder
    from spfsplatv2_tpu_torch.training.loop import random_drop_views
    from spfsplatv2_tpu_torch.training.optim import Optimizer
    from spfsplatv2_tpu_torch.training.step import init_train_state
    from spfsplatv2_tpu_torch.utils.drawing import draw_cameras

    cfg = load_config([repo / VGGT_10VIEW_PRESET],
                      ["checkpointing.pretrained_weights=null"])
    hw = tuple(cfg.image_shape)
    n_ctx = cfg.view_sampler.num_context_views
    offsets = [0.2 * i / (n_ctx - 1) for i in range(n_ctx)]
    t0 = time.perf_counter()
    encoder = get_encoder(cfg.encoder, seed=SEED, device=dev)
    place_vggt_scene(torch, encoder)
    n_params = sum(p.numel() for p in encoder.parameters())
    if n_params != VGGT_PARAMS:
        fail(f"the 10-view VGGT encoder has {n_params} parameters")
    init_s = time.perf_counter() - t0
    dec_cfg, eval_cfg = cfg.decoder, EvalConfig()
    evaluate_example(encoder, seeded_request(torch, dev, 2999, hw[0], offsets),
                     hw, dec_cfg, eval_cfg, device=dev)
    req = seeded_request(torch, dev, 3000, hw[0], offsets)
    (res,), serve_counts = serve_requests(torch, dev, encoder, [req], hw,
                                          dec_cfg, eval_cfg)
    # The warm-up request captured the encoder's graph; this one replays it.
    want = {k: 0 for k in serve_counts}
    want.update(composite_forward=1, cumsum_1d=2, encoder_graph_replay=1)
    vals = [*res["psnr"], *res["ssim"], *res["pose_rot_err_deg"]]
    if serve_counts != want or not bool(torch.isfinite(
            res["rendered"]).all()) or not all(np.isfinite(vals)):
        fail(f"vggt_10view request: launches {serve_counts}, metrics {vals}")

    # draw_cameras on the card and on the CPU, on the predicted poses.
    c, t = req["context"], req["target"]
    with torch.no_grad():
        out = encoder(c["image"][None], c["intrinsics"][None],
                      t["image"][None], t["intrinsics"][None])
    poses = out["extrinsics_cwt"][0]
    intr = torch.cat([c["intrinsics"], t["intrinsics"]])
    colors = torch.linspace(0.2, 1.0, poses.shape[0] * 3,
                            device=dev).reshape(-1, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drawn = draw_cameras(256, poses, intr, colors)
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t0) * 1e3
    drawn_cpu = draw_cameras(256, poses.cpu(), intr.cpu(), colors.cpu())
    draw = {"views": list(drawn.shape), "device": str(drawn.device),
            "card_ms": draw_ms,
            "max_abs_err_vs_cpu": float((drawn.cpu() - drawn_cpu).abs().max()),
            "lit_share": float((drawn > 0).float().mean())}
    if draw["max_abs_err_vs_cpu"] > 1e-4 or draw["lit_share"] == 0:
        fail(f"draw_cameras on the card: {draw}")
    del out
    torch.cuda.empty_cache()

    # One train step at b = 2 with the preset's context-view dropout.
    batch = seeded_batch(torch, dev, 3100, cfg.trainer.batch_size, hw[0],
                         offsets)
    batch = random_drop_views(batch, np.random.default_rng(SEED), cfg.train)
    batch["context_valid"] = torch.as_tensor(batch["context_valid"],
                                             device=dev)
    encoder.train()
    state = init_train_state(encoder, Optimizer(cfg.optimizer,
                                                encoder.named_parameters()))
    run = train_steps(torch, dev, state, cfg, hw,
                      build_lpips(seed=SEED, device=dev), [batch],
                      "vggt_10view train")
    emit({"phase": "vggt_10view", "preset": VGGT_10VIEW_PRESET,
          "params": n_params, "init_s": init_s, "context_views": n_ctx,
          "context_valid": batch["context_valid"].tolist(),
          "serve_launches": serve_counts,
          "encoder_ms": res["times"]["encoder"]["mean_s"] * 1e3,
          "decoder_ms": res["times"]["decoder"]["mean_s"] * 1e3,
          "request_peak_gb": res["peak_bytes"] / 1e9, "psnr": res["psnr"],
          "train": train_summary(run),
          "step_peak_gb": run["steps"][0]["peak_bytes"] / 1e9,
          "draw_cameras": draw})
    return {"serve": serve_counts, "train": run["launches"], "draw": draw,
            "drawn": drawn[0].cpu(), "k2_check": run["k2_vs_plain"]}


def parallel_phases(torch, repo: Path, dev, drawn) -> dict:
    """Phases "utils", "tile_shard_1024" and "ddp_2rank" on one seeded
    full-width flagship (bf16): a traced 256^2 request and a logger
    record; the 1024^2 request's Gaussians (the encoder through K5's
    forward) rendered once here and by two gloo ranks in 512-row bands,
    with the backward of both; the b = TRAIN_BATCH step here, then by
    two gloo ranks of TRAIN_BATCH // 2.  Returns each path's launch
    counts."""
    import dataclasses

    from spfsplatv2_tpu_torch.evaluation.evaluator import (
        EvalConfig,
        evaluate_example,
    )
    from spfsplatv2_tpu_torch.losses.lpips import build_lpips
    from spfsplatv2_tpu_torch.models import build_encoder
    from spfsplatv2_tpu_torch.models.decoder import (
        LONG_CONTEXT_DECODER,
        DecoderConfig,
    )
    from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config
    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.ops.rasterizer import render
    from spfsplatv2_tpu_torch.training.optim import Optimizer, OptimizerConfig
    from spfsplatv2_tpu_torch.training.step import (
        LossConfig,
        init_train_state,
        make_train_step,
    )
    from spfsplatv2_tpu_torch.utils import logger, profiling

    root = repo / "build" / "parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    encoder = build_encoder(SPFSplatV2Config(), seed=SEED, device=dev)
    paths = {}

    # ---- utils: a traced 256^2 request, a logger record -----------------
    hw = (FLAGSHIP_HW, FLAGSHIP_HW)
    req = seeded_request(torch, dev, 1050, hw[0])
    evaluate_example(encoder, req, hw, DecoderConfig(), EvalConfig(),
                     device=dev)
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    with profiling.trace(root / "profile") as prof:
        res = evaluate_example(encoder, req, hw, DecoderConfig(), EvalConfig(),
                               device=dev)
    traced_s = time.perf_counter() - t0
    paths["utils_traced_request"] = cuda_lib.launches()
    want = {k: 0 for k in paths["utils_traced_request"]}
    want.update(composite_forward=1, cumsum_1d=2, encoder_graph_replay=1)
    trace_file = root / "profile" / "trace.json"
    device_events = sum(e.device_type == torch.autograd.DeviceType.CUDA
                        for e in prof.events())
    if paths["utils_traced_request"] != want or not trace_file.exists() \
            or device_events == 0:
        fail(f"utils: traced request launches {paths['utils_traced_request']}"
             f", {device_events} device events")
    log = logger.LocalLogger(root / "log")
    log.log_scalars(0, {"psnr": res["psnr"][0], "ssim": res["ssim"][0]})
    log.log_image(0, "cameras", drawn["drawn"])
    log.close()
    record = json.loads((root / "log" / "metrics.jsonl").read_text())
    png = root / "log" / "images" / "cameras_00000000.png"
    if record["psnr"] != res["psnr"][0] or not png.exists():
        fail(f"utils: logger record {record}")
    emit({"phase": "utils", "draw_cameras": drawn["draw"],
          "trace_bytes": trace_file.stat().st_size,
          "trace_device_events": device_events, "traced_request_s": traced_s,
          "traced_launches": paths["utils_traced_request"],
          "logger_record": record, "logger_png_bytes": png.stat().st_size})
    del prof, res

    # ---- tile_shard_1024: the single render ------------------------------
    size = (HW_LONG, HW_LONG)
    long_req = seeded_request(torch, dev, 1010, HW_LONG)
    c, t = long_req["context"], long_req["target"]
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        out = encoder(c["image"][None], c["intrinsics"][None], t["image"][None],
                      t["intrinsics"][None])
    paths["tile_shard_1024_encoder"] = cuda_lib.launches()
    # The encoder's first call at this signature: its eager run and its
    # capture each count K5's and the view-masked kernel's launches.
    want = {k: 0 for k in paths["tile_shard_1024_encoder"]}
    want.update(flash_forward=2 * K5_PER_PASS,
                flash_view_masked=2 * VIEW_MASKED_PER_PASS,
                encoder_graph_eager=1)
    if paths["tile_shard_1024_encoder"] != want:
        fail(f"tile_shard_1024 encoder launches "
             f"{paths['tile_shard_1024_encoder']}, expected {want}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    g0 = out["gaussians"].map(lambda a: a[0])
    data = {"extrinsics": out["extrinsics_cwt"][0, 2:].contiguous(),
            "intrinsics": t["intrinsics"], "near": t["near"], "far": t["far"],
            "image_shape": size, "background": torch.zeros(1, 3, device=dev),
            "cfg": dataclasses.replace(
                LONG_CONTEXT_DECODER.rasterizer,
                scale_invariant=LONG_CONTEXT_DECODER.make_scale_invariant),
            "weights": [torch.randn(s, generator=gen, device=dev)
                        for s in ((1, *size, 3), (1, *size), (1, *size))],
            **{k: getattr(g0, k).contiguous() for k in GAUSSIAN_FIELDS}}
    del out, g0
    leaves = [data[k].clone().requires_grad_(True) for k in GAUSSIAN_FIELDS]
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = render(data["extrinsics"], data["intrinsics"], data["near"],
                    data["far"], size, data["background"], *leaves,
                    cfg=data["cfg"])
    sum((o * w).sum() for o, w in zip((single.color, single.depth,
                                       single.alpha), data["weights"])
        ).backward()
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    paths["tile_shard_1024_single"] = cuda_lib.launches()
    single_out = {k: getattr(single, k).detach().cpu()
                  for k in ("color", "depth", "alpha")}
    single_grads = [x.grad.cpu() for x in leaves]
    tile_dir = root / "tile"
    tile_dir.mkdir()
    torch.save(data, tile_dir / "tile_in.pt")
    n_gauss = data["means"].shape[0]
    del leaves, single, data
    gc.collect()
    torch.cuda.empty_cache()

    # ---- ddp_2rank: the step in this process -----------------------------
    encoder.train()
    optimizer = Optimizer(OptimizerConfig(), encoder.named_parameters())
    grads = capture_grads(torch, optimizer)
    state = init_train_state(encoder, optimizer)
    step = make_train_step(encoder, optimizer, hw, loss_cfg=LossConfig(),
                           lpips=build_lpips(seed=SEED, device=dev),
                           microbatch=TRAIN_BATCH)
    cuda_lib.reset_launch_counts()
    parent = run_train_step(torch, dev, state, step,
                            seeded_batch(torch, dev, 2100, TRAIN_BATCH, hw[0]))
    paths["ddp_one_process_step"] = cuda_lib.launches()
    parent_grad = grads[0]
    parent_params = torch.cat([p.detach().reshape(-1)
                               for p in optimizer.params]).cpu()
    n_params = sum(p.numel() for p in encoder.parameters())
    del encoder, optimizer, state, step, grads
    gc.collect()
    torch.cuda.empty_cache()

    # ---- ddp_2rank: two gloo ranks on the card ---------------------------
    ddp_dir = root / "ddp"
    ddp_dir.mkdir()
    t0 = time.perf_counter()
    ranks = spawn_ranks(ddp_rank, ddp_dir)
    ddp_s = time.perf_counter() - t0
    grad0 = torch.load(ddp_dir / "grad.pt")
    scale = float(parent_grad.abs().max())
    grad_err = float((grad0 - parent_grad).abs().max())
    grad_rel_norm = float(torch.linalg.vector_norm(grad0 - parent_grad)
                          / torch.linalg.vector_norm(parent_grad))
    param_err = float((torch.load(ddp_dir / "params.pt")
                       - parent_params).abs().max())
    del grad0, parent_grad, parent_params
    per_rank = {k: 0 for k in ranks[0]["launches"]}
    per_rank.update(composite_forward=TRAIN_BATCH // DDP_WORLD,
                    composite_backward=TRAIN_BATCH // DDP_WORLD,
                    cumsum_1d=2 * TRAIN_BATCH // DDP_WORLD)
    loss_p = parent["metrics"]["loss/total"]
    ratios = [r[key]["bytes"] / r["trainable_f32_bytes"] for r in ranks
              for key in ("all_reduce", "all_reduce_step2")]
    checks = {
        "loss": all(abs(r["loss"] - loss_p) <= DDP_LOSS_RTOL * abs(loss_p)
                    for r in ranks),
        "grad": grad_err <= DDP_GRAD_BAR * scale,
        "replicas": all(r["replicas_bit_identical"] for r in ranks),
        "launches": all(r["launches"] == per_rank for r in ranks),
        "metrics": ranks[0]["metrics"] == ranks[1]["metrics"],
        "audit": all(DDP_AUDIT_RATIO[0] <= x <= DDP_AUDIT_RATIO[1]
                     for x in ratios)}
    emit({"phase": "ddp_2rank", "preset": CLI_PRESET, "params": n_params,
          "batch": TRAIN_BATCH, "per_rank_batch": TRAIN_BATCH // DDP_WORLD,
          "backend": "gloo", "checks": checks,
          "loss_one_process": loss_p, "loss_ranks": [r["loss"] for r in ranks],
          "loss_rtol": DDP_LOSS_RTOL, "grad_max_abs_err": grad_err,
          "grad_max_abs": scale, "grad_err_share_of_max": grad_err / scale,
          "grad_bar_share_of_max": DDP_GRAD_BAR,
          "grad_rel_norm_err": grad_rel_norm,
          "updated_params_max_abs_err": param_err,
          "replicas_bit_identical": [r["replicas_bit_identical"]
                                     for r in ranks],
          "launches_a_rank": [r["launches"] for r in ranks],
          "all_reduce": [r["all_reduce"] for r in ranks],
          "all_reduce_step2": [r["all_reduce_step2"] for r in ranks],
          "trainable_f32_bytes": ranks[0]["trainable_f32_bytes"],
          "all_reduce_over_param_bytes": ratios,
          "overlap_rank0": ranks[0]["overlap"],
          "step_ms_one_process": parent["ms"],
          "step_ms_ranks": [r["step_ms"] for r in ranks],
          "peak_bytes_one_process": parent["peak_bytes"],
          "peak_bytes_ranks": [r["peak_bytes"] for r in ranks],
          "seconds": ddp_s,
          "note": "two processes share one card; gloo copies through the "
                  "host: not a multi-GPU number"})
    if not all(checks.values()):
        fail(f"ddp_2rank: {checks}")
    for r in ranks:
        paths[f"ddp_2rank_rank{r['rank']}"] = r["launches"]

    # ---- tile_shard_1024: two gloo ranks, 512-row bands ------------------
    t0 = time.perf_counter()
    tranks = spawn_ranks(tile_rank, tile_dir)
    tile_s = time.perf_counter() - t0
    got = torch.load(tile_dir / "tile_out.pt")
    image = {k: images_close(got[k], single_out[k], *TILE_BOUNDS[k])
             for k in TILE_BOUNDS}
    grad_check = {}
    for name, g, want_g in zip(GAUSSIAN_FIELDS, got["grads"], single_grads):
        g_scale = float(want_g.abs().max())
        per_gauss = (g - want_g).abs().reshape(n_gauss, -1).amax(1)
        grad_check[name] = {
            "max_abs_err": float(per_gauss.max()), "max_abs": g_scale,
            "share_within": float((per_gauss <= TILE_GRAD_TOL * g_scale)
                                  .float().mean())}
    fwd = {k: 0 for k in tranks[0]["launches"]}
    fwd.update(composite_forward=1, cumsum_1d=2)
    full = dict(fwd, composite_backward=1)
    checks = {
        "image": all(v["ok"] for v in image.values()),
        "grads": all(v["share_within"] >= TILE_GRAD_SHARE
                     for v in grad_check.values()),
        "ranks_agree": all(r["grads_bit_identical_across_ranks"]
                           for r in tranks),
        "launches": all(r["forward_launches"] == fwd and r["launches"] == full
                        for r in tranks)}
    emit({"phase": "tile_shard_1024", "g": n_gauss, "image_shape": list(size),
          "bands": DDP_WORLD, "band_rows": HW_LONG // DDP_WORLD,
          "encoder_launches": paths["tile_shard_1024_encoder"],
          "checks": checks, "vs_single": image, "grads_vs_single": grad_check,
          "grad_tol_share_of_max": TILE_GRAD_TOL,
          "grad_share_required": TILE_GRAD_SHARE,
          "single_forward_backward_ms": single_ms,
          "single_launches": paths["tile_shard_1024_single"],
          "ranks": tranks, "seconds": tile_s,
          "note": "two processes share one card; gloo copies through the "
                  "host: not a multi-GPU number"})
    if not all(checks.values()):
        fail(f"tile_shard_1024: {checks}")
    for r in tranks:
        paths[f"tile_shard_1024_rank{r['rank']}"] = r["launches"]
    shutil.rmtree(root)
    return {"paths": paths, "tile_image": image, "tile_grads": grad_check,
            "ddp_grad_err_share": grad_err / scale}


def write_nerfstudio_scenes(root: Path, names: list, rng) -> None:
    """Scenes in DL3DV's nerfstudio layout: `<name>/images/*.jpg` (270 x
    480, smooth seeded colours) and `<name>/transforms.json` (OpenGL
    camera-to-world, a dolly along x; intrinsics in pixels)."""
    import numpy as np

    from spfsplatv2_tpu_torch.data.chunk_io import encode_jpeg

    gl = np.diag([1.0, -1.0, -1.0, 1.0])
    for name in names:
        (root / name / "images").mkdir(parents=True)
        frames = []
        for i in range(CLI_DDP_FRAMES):
            low = rng.uniform(0, 1, (9, 16, 3))
            image = np.repeat(np.repeat(low, 30, 0), 30, 1)
            path = f"images/frame_{i:05d}.jpg"
            (root / name / path).write_bytes(encode_jpeg(image))
            c2w = np.eye(4)
            c2w[0, 3] = 0.05 * i
            c2w[:3, 3] += 0.01 * rng.standard_normal(3)
            frames.append({"file_path": path,
                           "transform_matrix": (c2w @ gl).tolist()})
        (root / name / "transforms.json").write_text(json.dumps({
            "w": 480, "h": 270, "fl_x": 400.0, "fl_y": 400.0, "cx": 240.0,
            "cy": 135.0, "frames": frames}))


def cli_ddp_phase(torch, repo: Path, dev) -> dict:
    """Phase "cli_ddp": `python -m torch.distributed.run --standalone
    --nproc_per_node=2 -m spfsplatv2_tpu_torch.main` on the DL3DV preset
    (the port's rule takes gloo: two ranks share the one card) for
    CLI_DDP_STEPS steps of CLI_DDP_BATCH a rank, on chunks that
    `data/convert_dl3dv.py` writes from seeded nerfstudio-layout scenes;
    then mode=test in this process from rank 0's checkpoint.  Returns
    mode=test's launch counts (the ranks' counts stay in their
    processes)."""
    import ast
    import re

    import numpy as np

    from spfsplatv2_tpu_torch import main as cli
    from spfsplatv2_tpu_torch.data import convert_dl3dv
    from spfsplatv2_tpu_torch.ops import cuda_lib

    root = repo / "build" / "cli_ddp"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    write_nerfstudio_scenes(root / "src_train", [
        f"train_{i:03d}" for i in range(CLI_DDP_SCENES)], rng)
    write_nerfstudio_scenes(root / "src_test", list(CLI_DDP_INDEX), rng)
    chunks = root / "chunks"
    train_index = convert_dl3dv.convert_dataset(root / "src_train", chunks,
                                                "train", 1)
    test_index = convert_dl3dv.convert_dataset(root / "src_test", chunks,
                                               "test", 1)
    index = root / "index.json"
    index.write_text(json.dumps(CLI_DDP_INDEX))
    data_s = time.perf_counter() - t0
    if len(train_index) != CLI_DDP_SCENES or len(test_index) != len(
            CLI_DDP_INDEX):
        fail(f"cli_ddp: converted {len(train_index)} / {len(test_index)}")

    out_dir, test_dir = root / "out", root / "test_out"
    overrides = [f"dataset.roots=[{chunks}]",
                 "checkpointing.pretrained_weights=null",
                 f"trainer.batch_size={CLI_DDP_BATCH}",
                 f"trainer.max_steps={CLI_DDP_STEPS}",
                 "trainer.val_check_interval=0",
                 "checkpointing.every_n_train_steps=0",
                 "train.print_log_every_n_steps=1", f"output_dir={out_dir}",
                 f"evaluation_sampler.index_path={index}",
                 f"test.output_path={test_dir}", "test.save_image=false"]
    config = ["--config", str(repo / DL3DV_PRESET)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={DDP_WORLD}", "-m", "spfsplatv2_tpu_torch.main",
           *config, *overrides]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                          timeout=900)
    train_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli_ddp: torchrun rc {proc.returncode}\n{proc.stdout[-4000:]}"
             f"\n{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    scenes = {r: [] for r in range(DDP_WORLD)}
    for line in lines:
        m = re.match(r"\[rank (\d+)/\d+\] step \d+ scenes (\[.*\])$", line)
        if m:
            scenes[int(m.group(1))].extend(ast.literal_eval(m.group(2)))
    step_lines = [line for line in lines if line.startswith("step ")]
    ckpt = out_dir / "checkpoints" / "step_-1"
    sets = [set(v) for v in scenes.values()]
    checks = {
        "scenes_a_rank": all(len(v) == CLI_DDP_STEPS * CLI_DDP_BATCH
                             for v in scenes.values()),
        "disjoint": not sets[0] & sets[1],
        "step_lines": len(step_lines) == CLI_DDP_STEPS,
        "checkpoint": (ckpt / "state.pt").exists()}
    if not all(checks.values()):
        fail(f"cli_ddp: {checks}\n{proc.stdout[-4000:]}")
    ckpt_bytes = (ckpt / "state.pt").stat().st_size

    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    rc = run_cli(cli, [*config, *overrides, "mode=test",
                       f"checkpointing.load={ckpt}"])
    test_s = time.perf_counter() - t0
    test_counts = cuda_lib.launches()
    targets = sum(len(e["target"]) for e in CLI_DDP_INDEX.values())
    want = {k: 0 for k in test_counts}
    want.update(composite_forward=targets, cumsum_1d=2 * targets,
                encoder_graph_eager=1, encoder_graph_replay=targets - 1)
    scores = test_dir / "scores_all_avg.json"
    if rc != 0 or test_counts != want or not scores.exists():
        fail(f"cli_ddp test: rc {rc}, launches {test_counts} (expected "
             f"{want})")
    emit({"phase": "cli_ddp", "preset": DL3DV_PRESET, "overrides": overrides,
          "backend": "gloo", "ranks": DDP_WORLD, "data_s": data_s,
          "train_scenes": len(train_index),
          "train_chunks": len(set(train_index.values())),
          "torchrun_rc": proc.returncode, "torchrun_s": train_s,
          "checks": checks, "scenes_by_rank": scenes,
          "step_lines": step_lines, "checkpoint_bytes": ckpt_bytes,
          "test_rc": rc, "test_s": test_s, "test_launches": test_counts,
          "averages": json.loads(scores.read_text()),
          "note": "two processes share one card over gloo: the NCCL "
                  "choice is not exercised here"})
    shutil.rmtree(root)
    return {"cli_ddp_test": test_counts}


def overfit_short_phase(torch, repo: Path, dev) -> dict:
    """Phase "overfit_short": `overfit.run_overfit` for OVERFIT_STEPS
    steps on the card under `build/overfit_short/` (deleted after), the
    loop's train step wrapped to read the launch counts and the loss
    around each step, and to profile one step.  Returns the run's launch
    counts (the steps and the memory guard's probe)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from spfsplatv2_tpu_torch import overfit
    from spfsplatv2_tpu_torch.ops import cuda_lib
    from spfsplatv2_tpu_torch.training import loop

    root = repo / "build" / "overfit_short"
    shutil.rmtree(root, ignore_errors=True)
    steps, profiled = [], {}
    real = loop.make_train_step

    def profiled_step(step_fn, state, batch):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = step_fn(state, batch)
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        # A user annotation's device span (the optimizer's step) covers
        # kernels already counted: device operations only.
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        busy_ms = sum(e.device_time_total for e in kernels) / 1e3
        by_name = {}
        for e in kernels:
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + \
                e.device_time_total / 1e3
        profiled.update(
            step=len(steps), wall_ms_under_profiler=wall_ms,
            device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
            device_operations=len(kernels),
            top_ms_name=sorted(((v, k) for k, v in by_name.items()),
                               reverse=True)[:8])
        return out

    def counted(*args, **kwargs):
        step_fn = real(*args, **kwargs)

        def step(state, batch):
            before = cuda_lib.launches()
            if len(steps) == OVERFIT_PROFILE_STEP:
                state, metrics = profiled_step(step_fn, state, batch)
            else:
                state, metrics = step_fn(state, batch)
            steps.append({"launches": {k: v - before[k] for k, v in
                                       cuda_lib.launches().items()},
                          **metrics})
            return state, metrics

        step.audit = step_fn.audit
        return step

    loop.make_train_step = counted
    try:
        art = overfit.run_overfit(
            root, root / "artifact.json", OVERFIT_STEPS, dev,
            [f"train.print_log_every_n_steps={OVERFIT_LOG_EVERY}"])
    finally:
        loop.make_train_step = real
    want = {k: OVERFIT_STEP_LAUNCHES.get(k, 0) for k in cuda_lib.launches()}
    losses = np.array([st["loss/total"] for st in steps])
    psnrs = np.array([st["train/psnr"] for st in steps])
    skipped = steps[-1]["grad/skipped_steps"]
    first = float(losses[:OVERFIT_WINDOW].mean())
    last = float(losses[-OVERFIT_WINDOW:].mean())
    checks = {
        "steps": len(steps) == OVERFIT_STEPS,
        "finite": bool(np.isfinite(losses).all() and np.isfinite(psnrs).all()),
        "skipped": skipped < 0.05 * OVERFIT_STEPS + 10,
        "loss_falls": last < first,
        "launches_each_step": all(st["launches"] == want for st in steps),
        "params": art["params"] == FLAGSHIP_PARAMS,
    }
    emit({"phase": "overfit_short", "steps": len(steps),
          "steps_per_s": art["steps_per_s"], "seconds": art["seconds"],
          "peak_bytes": art["peak_bytes"], "guard": art["guard"],
          "params": art["params"], "skipped": skipped,
          "loss_first_window": first, "loss_last_window": last,
          "launches_a_step": steps[0]["launches"],
          "launches": art["launches"], "profiled_step": profiled,
          "checks": checks, "curve": art["curve"]})
    if not all(checks.values()):
        fail(f"overfit_short: {checks}")
    shutil.rmtree(root)
    return art["launches"]


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
    from spfsplatv2_tpu_torch.models import build_encoder
    from spfsplatv2_tpu_torch.models.decoder import (
        LONG_CONTEXT_DECODER,
        DecoderConfig,
        decode_splatting,
    )
    from spfsplatv2_tpu_torch.models.encoder import SPFSplatV2Config
    from spfsplatv2_tpu_torch.losses.lpips import build_lpips
    from spfsplatv2_tpu_torch.ops import attention, cuda_lib, raster_cuda
    from spfsplatv2_tpu_torch.ops.raster_common import project_gaussians
    from spfsplatv2_tpu_torch.ops.raster_cuda import (
        accumulate_rows,
        composite_backward_cuda,
        composite_backward_plain,
        composite_forward_cuda,
        composite_forward_plain_work,
        composite_prefix,
        cull_box_plain,
        packed_rows,
    )
    from spfsplatv2_tpu_torch.ops.raster_ref import composite_reference
    from spfsplatv2_tpu_torch.ops.raster_tiled import bin_gaussians_prefix
    from spfsplatv2_tpu_torch.ops.rasterizer import (
        RasterizerConfig,
        entry_budget,
        render,
    )
    from spfsplatv2_tpu_torch.training.optim import Optimizer, OptimizerConfig
    from spfsplatv2_tpu_torch.training.step import (
        LossConfig,
        init_train_state,
        make_train_step,
    )
    from spfsplatv2_tpu_torch.ops.segscan import (
        cumsum_1d_cuda,
        cumsum_1d_plain,
        segmented_scan_lanes_cuda,
        segmented_scan_lanes_plain,
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
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          # In fresh interpreters: the port needs Pillow, never PyYAML.
          **{f"{mod}_imports": subprocess.run(
              [sys.executable, "-c", f"import {mod}"],
              capture_output=True).returncode == 0 for mod in ("yaml", "PIL")},
          "gxx": shutil.which("g++")})

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_lib.build_all()
    for name in cuda_lib.SIGNATURES:
        cuda_lib.library(name)
    # Registers, spills and the wgmma serialisation warnings (C75xx).
    ptxas = [line.strip() for log in logs.values() for line in log.splitlines()
             if "registers" in line or "spill" in line or "(C75" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs), "ptxas": ptxas})

    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---- 3. K3: cumsum_1d ---------------------------------------------
    checks = []
    # The 256^2 path's n, a ragged n, and the 1024^2 path's n = 2 x 1024^2
    # (256 tiles: look-backs past one window of 32 words).
    for n in (131072, 100003, 1 << 21):
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
    library = lambda: torch.cumsum(x, 0, dtype=torch.int32)  # noqa: E731
    device_ms, per_call = profile_calls(torch, lambda: cumsum_1d_cuda(x),
                                        K3_PROFILE_CALLS)
    if sum(per_call.values()) != 1.0:
        fail(f"K3 ran {per_call} device operations a call, not one kernel")
    library_device_ms, library_per_call = profile_calls(torch, library,
                                                        K3_PROFILE_CALLS)
    k3 = {
        "ms": time_ms(torch, lambda: cumsum_1d_cuda(x), 200),
        "device_ms": device_ms,
        "plain_ms": time_ms(torch, lambda: cumsum_1d_plain(x), 200),
        "library_ms": time_ms(torch, library, 200),
        "library_device_ms": library_device_ms,
        "max_abs_err": float((cumsum_1d_cuda(x) - cumsum_1d_plain(x))
                             .abs().max()),
        "bound_ms": max(2 * n * 4 / H100_BYTES_PER_S,
                        n / H100_FP32_PER_S) * 1e3,
        "bound_by": "bytes",
    }
    emit({"phase": "K3", "checks": checks, "n": n, "dtype": "int32", **k3,
          "device_ops_per_call": per_call,
          "library_device_ops_per_call": library_per_call,
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
    evaluated = evaluated_pairs(torch, cull_box_plain, packed, bins)
    k1_bound = composite_bound(bins, walked, blended, out_k.numel(), False)
    k1 = {
        "ms": time_ms(torch, lambda: composite_forward_cuda(*args), 50),
        "plain_ms": time_ms(torch, lambda: composite_forward_plain_work(*args),
                            3, warmup=1),
        "library_ms": None,
        "max_abs_err": max(v["max_abs_err"] for v in k1_check.values()),
        "bound_ms": k1_bound["bound_ms"], "bound_by": k1_bound["bound_by"],
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
          "pairs_evaluated": evaluated,
          "vs_plain": k1_check, "vs_oracle_64px_max_abs_err": oracle,
          **k1_bound, **k1})

    # "tiled", the plain-torch backend (no kernel), against "prefix" (K1,
    # K3) on phase 4's scene and camera, with its opacities mapped into
    # [0.05, 0.34): above 0.35 the tiled backend's radius box keeps alpha
    # that the prefix binning's 3-sigma axis box drops, by design.
    tiled_args = (c2w[None], k_norm[None], torch.ones(1, device=dev),
                  torch.full((1,), 100.0, device=dev), (hw, hw),
                  torch.zeros(1, 3, device=dev), means, covs, harm,
                  0.05 + (opac - 0.05) * (0.29 / 0.9))
    backend_cfgs = {b: RasterizerConfig(backend=b, entry_budget_factor=4.0)
                    for b in ("tiled", "prefix")}
    with torch.no_grad():
        outs = {b: render(*tiled_args, cfg=c) for b, c in backend_cfgs.items()}
    tiled_check = {}
    for name, atol, hard in (("color", 3e-5, 5e-3), ("depth", 3e-4, 2e-2),
                             ("alpha", 3e-5, 5e-3)):
        diff = (getattr(outs["tiled"], name) - getattr(outs["prefix"], name)).abs()
        frac_ok = float((diff <= atol).float().mean())
        tiled_check[name] = {"max_abs_err": float(diff.max()),
                             "frac_within": frac_ok, "atol": atol}
        if float(diff.max()) > hard or frac_ok < 0.999:
            fail(f"tiled vs prefix {name}: {tiled_check[name]}")
    emit({"phase": "tiled_256", "g": g, "hw": hw,
          "dropped_entries": {b: int(o.dropped_entries[0])
                              for b, o in outs.items()},
          "tiled_vs_prefix": tiled_check,
          **{f"{b}_render_ms": time_ms(
              torch, lambda c=c: render(*tiled_args, cfg=c), 5, warmup=1)
             for b, c in backend_cfgs.items()}})
    del outs

    # ---- 5. main path: evaluate_example at full width -----------------
    t0 = time.perf_counter()
    cfg = SPFSplatV2Config()
    encoder = build_encoder(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in encoder.parameters())
    emit({"phase": "encoder_init", "seconds": time.perf_counter() - t0,
          "params": n_params, "compute_dtype": cfg.backbone.compute_dtype})

    def request(i: int, size: int = hw) -> dict:
        return seeded_request(torch, dev, 1000 + i, size)

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
    counts = cuda_lib.launches()
    cams = sum(r["rendered"].shape[0] for r in results)
    # One encoder call a camera, each a replay of the graph that the
    # warm-up request captured.
    if counts["composite_forward"] != cams or counts["cumsum_1d"] != 2 * cams \
            or counts["encoder_graph_eager"] != 0 \
            or counts["encoder_graph_replay"] != cams:
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
    rproj = project_gaussians(*pargs)
    bargs = (rproj, (hw, hw), rcfg.max_tiles_per_gaussian, rcfg.chunk,
             entry_budget(rcfg, g0.means.shape[0]), rcfg.base_tiles_per_gaussian,
             rcfg.big_pool_factor, rcfg.depth_key)
    rbins = bin_gaussians_prefix(*bargs)
    bg0 = torch.zeros(3, device=dev)
    stages = {
        "project_ms": time_ms(torch, lambda: project_gaussians(*pargs), 10),
        "bin_ms": time_ms(torch, lambda: bin_gaussians_prefix(*bargs), 10),
        "composite_ms": time_ms(
            torch, lambda: composite_prefix(rproj, rbins, (hw, hw), bg0), 10),
        "n_live": int(rbins.n_live),
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

    # ---- ortho_256: the same Gaussians, orthographic ------------------
    # The first request's Gaussians from its first context view's camera.
    ortho_256 = ortho_phase(
        torch, dev, "ortho_256", out["gaussians"],
        out["extrinsics_cwt"][:, :1], c["intrinsics"][None, :1],
        c["near"][None, :1], c["far"][None, :1], (hw, hw), dec_cfg, SEED + 256)

    # ---- 7. K2: composite_backward -----------------------------------
    # Phase 4's scene, bins and K1 output, with seeded cotangents.
    cot = torch.randn(out_k.shape, generator=gen, device=dev)
    bwd_args = (*args, out_k, cot)
    rows_k = composite_backward_cuda(*bwd_args)
    torch.cuda.synchronize()
    rows_p = composite_backward_plain(*bwd_args)
    k2_check = check_k2_rows(accumulate_rows, rows_k, rows_p, bins, g,
                             "synthetic scene")
    # Gradients of the 64^2 scene (phase 4's oracle scene, non-black
    # background) through K1 + K2 against the dense oracle's autograd.
    leaves = {k: getattr(sproj, k).detach().clone().requires_grad_(True)
              for k in ("xy", "conic", "color", "opacity", "depth")}
    lproj = sproj._replace(**leaves)
    weights = [torch.randn(sh, generator=gen, device=dev)
               for sh in ((64, 64, 3), (64, 64), (64, 64))]

    def weighted(outs):
        return sum((o * w).sum() for o, w in zip(outs, weights))

    cuda_lib.reset_launch_counts()
    ours_g = torch.autograd.grad(weighted(composite_prefix(lproj, sbins,
                                                           (64, 64), bg)),
                                 list(leaves.values()))
    if cuda_lib.launch_counts["composite_backward"] != 1:
        fail(f"oracle check did not launch K2: {cuda_lib.launch_counts}")
    ref_g = torch.autograd.grad(weighted(composite_reference(lproj, (64, 64),
                                                             bg)),
                                list(leaves.values()))
    k2_oracle = {}
    for name, a, b in zip(leaves, ours_g, ref_g):
        err = float((a - b).abs().max())
        k2_oracle[name] = err
        if not bool(torch.isfinite(a).all()) or err > 2e-3 * float(
                b.abs().max()):
            fail(f"K2 d{name} vs the dense oracle: max {err}, "
                 f"scale {float(b.abs().max())}")
    k2_bound = composite_bound(bins, walked, blended, out_k.numel(), True)
    k2 = {
        "ms": time_ms(torch, lambda: composite_backward_cuda(*bwd_args), 50),
        "plain_ms": time_ms(torch, lambda: composite_backward_plain(*bwd_args),
                            2, warmup=1),
        "library_ms": None,
        "max_abs_err": k2_check["per_gaussian_max_abs_err"],
        "bound_ms": k2_bound["bound_ms"], "bound_by": k2_bound["bound_by"],
    }
    emit({"phase": "K2", "g": g, "e_pad": bins.e_pad, **k2_check,
          "vs_oracle_64px_max_abs_err": k2_oracle, **k2_bound, **k2})

    # ---- 8. K4: segmented_scan_lanes ----------------------------------
    # Phase 7's rows in source order, one row per real field (the shape
    # the backward gives it under SPFSPLAT_ACCUM=segscan).
    rows_s = rows_k[bins.src_order.long()]
    vals = rows_s.T.contiguous()                        # (10, e_pad)
    seg = bins.src_sorted
    scan_k = segmented_scan_lanes_cuda(vals, seg)
    torch.cuda.synchronize()
    scan_p = segmented_scan_lanes_plain(vals, seg)
    scale = segmented_scan_lanes_plain(vals.abs(), seg)
    if not bool(((scan_k - scan_p).abs() <= 1e-5 * scale + 1e-6).all()):
        fail("K4 outside 1e-5 x the running sum of |x|")
    sums_out = torch.zeros((g + 1, 10), device=dev)
    k4_bytes = 2 * vals.numel() * 4 + seg.numel() * 4
    # One kernel a call (its look-back's status words are zeroed by a
    # memset on the stream, a device operation but no kernel launch).
    k4_device_ms, k4_per_call = profile_calls(
        torch, lambda: segmented_scan_lanes_cuda(vals, seg), K3_PROFILE_CALLS)
    k4_kernels = {name: c for name, c in k4_per_call.items()
                  if not name.lower().startswith("memset")}
    if list(k4_kernels.values()) != [1.0]:
        fail(f"K4 ran {k4_per_call} device operations a call, not one "
             "kernel")
    k4 = {
        "ms": time_ms(torch, lambda: segmented_scan_lanes_cuda(vals, seg), 100),
        "device_ms": k4_device_ms,
        "plain_ms": time_ms(torch, lambda: segmented_scan_lanes_plain(vals, seg),
                            10),
        "library_ms": time_ms(torch, lambda: sums_out.zero_().index_add_(
            0, seg.long(), rows_s), 100),
        "max_abs_err": float((scan_k - scan_p).abs().max()),
        "bound_ms": max(k4_bytes / H100_BYTES_PER_S,
                        vals.numel() / H100_FP32_PER_S) * 1e3,
        "bound_by": "bytes",
    }
    emit({"phase": "K4", "rows": vals.shape[0], "n": vals.shape[1],
          "segments": int((bins.live_counts > 0).sum()),
          "bound_bytes": k4_bytes, "device_ops_per_call": k4_per_call,
          "library": "index_add_ of the same rows into (g + 1, 10) sums", **k4})

    # ---- 9. test-time pose alignment ----------------------------------
    align_cfg = EvalConfig(align_pose=True, pose_align_steps=ALIGN_STEPS,
                           opt_lr=ALIGN_LR)
    ex = request(3)
    before = evaluate_example(encoder, ex, (hw, hw), dec_cfg, eval_cfg,
                              device=dev)
    bench = Benchmarker(dev)
    cuda_lib.reset_launch_counts()
    after = evaluate_example(encoder, ex, (hw, hw), dec_cfg, align_cfg,
                             benchmarker=bench, device=dev)
    align_counts = cuda_lib.launches()
    if align_counts["composite_backward"] != ALIGN_STEPS or (
            align_counts["encoder_graph_eager"],
            align_counts["encoder_graph_replay"]) != (0, 1):
        fail(f"align: launches {align_counts} for {ALIGN_STEPS} steps and "
             "one encoder replay")
    tgt_img = ex["target"]["image"]
    mse = {name: float(((torch.clamp(r["rendered"], 0, 1) - tgt_img) ** 2)
                       .mean()) for name, r in (("before", before),
                                                ("after", after))}
    if not all(v == v and v != float("inf") for v in mse.values()):
        fail(f"align: non-finite loss {mse}")
    times = bench.summarize()
    emit({"phase": "align", "steps": ALIGN_STEPS, "lr": ALIGN_LR,
          "align_ms": times["pose_optimize"]["mean_s"] * 1e3,
          "encoder_ms": times["encoder"]["mean_s"] * 1e3,
          "mse_before": mse["before"], "mse_after": mse["after"],
          "psnr_before": before["psnr"], "psnr_after": after["psnr"],
          "pose_rot_err_deg_before": before["pose_rot_err_deg"],
          "pose_rot_err_deg_after": after["pose_rot_err_deg"],
          "launches": align_counts})

    # ---- 10. K5: flash attention at the 1024^2 path's shapes ----------
    k5 = {}
    for name, shape in K5_SHAPES.items():
        k5[name] = k5_phase(torch, attention, name, shape, gen, dev,
                            torch.bfloat16)
        emit({"phase": "K5", "call": name, **k5[name]})
    torch.cuda.empty_cache()

    # ---- 10b. the view-masked kernel at the cross-attention shapes -----
    view_masked = {}
    for name, spec in VIEW_MASKED_SHAPES.items():
        view_masked[name] = view_masked_phase(torch, attention, spec, gen, dev)
        emit({"phase": "view_masked", "call": name, **view_masked[name]})
        torch.cuda.empty_cache()

    # ---- 11. the long-context serving path (1024^2) -------------------
    long_dec = LONG_CONTEXT_DECODER
    long_size = (HW_LONG, HW_LONG)
    evaluate_example(encoder, request(-2, HW_LONG), long_size, long_dec,
                     eval_cfg, device=dev)
    long_requests = [request(10 + i, HW_LONG) for i in range(3)]
    long_results, long_counts = serve_requests(
        torch, dev, encoder, long_requests, long_size, long_dec, eval_cfg)
    n_req = len(long_requests)
    # The warm-up request captured the encoder's graph: each request
    # replays it, and K5 and the view-masked kernel run inside the
    # replay, where only the device trace sees them.
    want = {k: 0 for k in long_counts}
    want.update(encoder_graph_replay=n_req, composite_forward=n_req,
                cumsum_1d=2 * n_req)
    if long_counts != want:
        fail(f"1024^2 serving launch counts {long_counts}, expected {want}")
    replayed = replayed_kernels(torch, lambda: evaluate_example(
        encoder, long_requests[0], long_size, long_dec, eval_cfg, device=dev),
        ("flash_forward_kernel", "view_masked_fwd_kernel"))
    if replayed != {"flash_forward_kernel": K5_PER_PASS,
                    "view_masked_fwd_kernel": VIEW_MASKED_PER_PASS}:
        fail(f"1024^2 serving: a replayed request ran {replayed}, not "
             f"{K5_PER_PASS} K5 and {VIEW_MASKED_PER_PASS} view-masked "
             f"kernels")
    for i, res in enumerate(long_results):
        if tuple(res["rendered"].shape) != (1, HW_LONG, HW_LONG, 3):
            fail(f"1024^2 request {i}: rendered shape "
                 f"{tuple(res['rendered'].shape)}")
        vals = [*res["psnr"], *res["ssim"], *res["pose_rot_err_deg"]]
        if not bool(torch.isfinite(res["rendered"]).all()) or not all(
                v == v and abs(v) != float("inf") for v in vals):
            fail(f"1024^2 request {i}: non-finite output")
        emit({"phase": "request_1024", "index": i,
              "encoder_ms": res["times"]["encoder"]["mean_s"] * 1e3,
              "decoder_ms": res["times"]["decoder"]["mean_s"] * 1e3,
              "psnr": res["psnr"], "ssim": res["ssim"],
              "dropped_entries": res["dropped_entries"],
              "peak_bytes": res["peak_bytes"]})
    # One encoder block's real q, k, v (block 12 of 24), captured from an
    # encoder pass on the first request, through K5 against the plain
    # version.
    long_out, captured = encoder_pass_capturing_k5(torch, attention, encoder,
                                                   long_requests[0])
    t = long_requests[0]["target"]
    if len(captured) != K5_PER_PASS:
        fail(f"1024^2 encoder pass took the flash branch {len(captured)} times")
    bq, bk, bv, bscale = captured[K5_CHECK_CALL]
    real_o, _ = attention.flash_forward_cuda(bq, bk, bv, bscale)
    real_p, _ = attention.flash_forward_plain(bq, bk, bv, bscale)
    real_check = max_err(real_o, real_p)
    del captured
    if not real_check["max_abs_err"] <= K5_TOLS["bfloat16"][0] * real_check[
            "ref_max_abs"]:
        fail(f"K5 on encoder block 12's q, k, v vs plain: {real_check}")
    emit({"phase": "serving_1024", "requests": n_req, "launches": long_counts,
          "replayed_kernels_a_request": replayed,
          "encoder_ms": [r["times"]["encoder"]["mean_s"] * 1e3
                         for r in long_results],
          "decoder_ms": [r["times"]["decoder"]["mean_s"] * 1e3
                         for r in long_results],
          "peak_bytes": max(r["peak_bytes"] for r in long_results),
          "encoder_block12_qkv": {"shape": list(bq.shape), **real_check},
          "seconds_total": time.perf_counter() - t_start})
    del long_results

    # That request's render (the encoder pass above: its Gaussians and
    # pose) through K1 and K3 against the same render with both
    # dispatchers routed to their plain versions on the card's tensors,
    # with phase 4's bars (depth's relative to its max); K3 exact on each
    # prefix sum's real input.
    pose = long_out["extrinsics_cwt"][:, 2:]
    cams_args = (pose, t["intrinsics"][None], t["near"][None],
                 t["far"][None], long_size, long_dec)
    render_check, scan_ns = render_vs_plain(
        torch, decode_splatting, cams_args, long_out["gaussians"], "1024^2")
    # K2 on that camera's projection and bins, with seeded cotangents.
    g_long = long_out["gaussians"].means.shape[1]
    inv_near = 1.0 / t["near"][0]
    cam = pose[0, 0].clone()
    cam[:3, 3] = cam[:3, 3] * inv_near
    g0 = long_out["gaussians"].map(lambda a: a[0])
    lproj = project_gaussians(g0.means * inv_near, g0.covariances * inv_near**2,
                              g0.harmonics, g0.opacities, cam,
                              t["intrinsics"][0], long_size)
    lr = long_dec.rasterizer
    lbins = bin_gaussians_prefix(
        lproj, long_size, lr.max_tiles_per_gaussian, lr.chunk,
        entry_budget(lr, g_long), lr.base_tiles_per_gaussian,
        lr.big_pool_factor, lr.depth_key)
    largs = (packed_rows(lproj), lbins.src, lbins.counts, lbins.starts,
             lbins.num_tiles_xy[1])
    lfwd = composite_forward_cuda(*largs)
    lcot = torch.randn(lfwd.shape, generator=gen, device=dev)
    lrows_k = composite_backward_cuda(*largs, lfwd, lcot)
    torch.cuda.synchronize()
    lrows_p = composite_backward_plain(*largs, lfwd, lcot)
    k2_long = check_k2_rows(accumulate_rows, lrows_k, lrows_p, lbins, g_long,
                            "1024^2 camera")
    del lrows_p
    # K1 and K2 timed on that camera's bins, beside their bounds.
    _, lwalked, lblended = composite_forward_plain_work(*largs)
    levaluated = evaluated_pairs(torch, cull_box_plain, largs[0], lbins)
    at_1024 = {}
    for name, fn, fargs, backward in (
            ("composite_forward", composite_forward_cuda, largs, False),
            ("composite_backward", composite_backward_cuda,
             (*largs, lfwd, lcot), True)):
        at_1024[name] = {
            "ms": time_ms(torch, lambda fn=fn, fargs=fargs: fn(*fargs), 20),
            **composite_bound(lbins, lwalked, lblended, lfwd.numel(),
                              backward)}
    emit({"phase": "check_1024", "g": g_long,
          "n_tiles": lbins.counts.shape[0], "e_pad": lbins.e_pad,
          "n_live": int(lbins.n_live), "pairs_walked": lwalked,
          "pairs_blended": lblended, "pairs_evaluated": levaluated,
          "render_vs_plain": render_check, "k3_exact_on_inputs_n": scan_ns,
          "k2_vs_plain": k2_long, "kernels": at_1024,
          "seconds_total": time.perf_counter() - t_start})
    long_gaussians = long_out["gaussians"]
    long_ctx_pose = long_out["extrinsics_cwt"][:, :1]
    del long_out, g0, lproj, lbins, largs, lfwd, lcot, lrows_k
    torch.cuda.empty_cache()
    # ortho_1024: the same request's Gaussians, orthographic, with the
    # depth order's agreement on 2^18 of them (the rank key fits 31 bits).
    lctx = long_requests[0]["context"]
    ortho_1024 = ortho_phase(
        torch, dev, "ortho_1024", long_gaussians, long_ctx_pose,
        lctx["intrinsics"][None, :1], lctx["near"][None, :1],
        lctx["far"][None, :1], long_size, long_dec, SEED + 1024,
        order_sample=ORTHO_ORDER_SAMPLE)
    del long_gaussians, long_ctx_pose
    torch.cuda.empty_cache()

    # ---- conv_probe: the flagship heads' float32 convolutions ----------
    emit({"phase": "conv_probe", "heads": "flagship DPTHead / DPTGSHead",
          "maps": FLAGSHIP_CONV_MAPS,
          "convs": conv_probe(torch, dev, FLAGSHIP_CONVS, FLAGSHIP_CONV_MAPS)})

    # ---- 12. the training path ----------------------------------------
    lpips = build_lpips(seed=SEED, device=dev)
    encoder.train()
    optimizer = Optimizer(OptimizerConfig(), encoder.named_parameters())
    state = init_train_state(encoder, optimizer)
    train_step = make_train_step(encoder, optimizer, (hw, hw), dec_cfg,
                                 LossConfig(), lpips,
                                 microbatch=TRAIN_MICROBATCH)

    def train_batch(i: int, b: int = TRAIN_BATCH, size: int = hw) -> dict:
        return seeded_batch(torch, dev, 2000 + i, b, size)

    def run_step(batch, step_fn=train_step) -> dict:
        return run_train_step(torch, dev, state, step_fn, batch)

    batches = [train_batch(i) for i in range(4)]
    cuda_lib.reset_launch_counts()
    steps = [run_step(batch) for batch in batches[:3]]
    train_counts = cuda_lib.launches()
    per_step = {k: 0 for k in train_counts}
    per_step.update(composite_forward=TRAIN_BATCH,
                    composite_backward=TRAIN_BATCH, cumsum_1d=2 * TRAIN_BATCH)
    if train_counts != {k: 3 * v for k, v in per_step.items()}:
        fail(f"train launch counts {train_counts} for 3 steps of "
             f"{TRAIN_BATCH} cameras")
    for st in steps:
        emit({"phase": "train_step", "microbatch": TRAIN_MICROBATCH, **st})
    # One more step under the JAX package's accumulation switch.
    raster_cuda.ACCUM_MODE = "segscan"
    cuda_lib.reset_launch_counts()
    seg_step = run_step(batches[3])
    segscan_counts = cuda_lib.launches()
    raster_cuda.ACCUM_MODE = "segsum"
    if segscan_counts["segmented_scan"] != TRAIN_BATCH:
        fail(f"segscan step launched K4 {segscan_counts['segmented_scan']} "
             f"times for {TRAIN_BATCH} cameras")
    emit({"phase": "train_step", "accumulation": "segscan",
          "launches": segscan_counts, **seg_step})
    emit({"phase": "train", "batch": TRAIN_BATCH,
          "microbatch": TRAIN_MICROBATCH, "steps": len(steps),
          "launches": train_counts,
          "step_ms": [st["ms"] for st in steps],
          "peak_bytes": max(st["peak_bytes"] for st in steps),
          "branches": [st["branch"] for st in steps],
          "skipped_steps": optimizer.skipped_count,
          "applied_updates": optimizer.count,
          "seconds_total": time.perf_counter() - t_start})
    del batches
    torch.cuda.empty_cache()

    # ---- 13. the long-context training path (1024^2) ------------------
    long_train_step = make_train_step(encoder, optimizer, long_size, long_dec,
                                      LossConfig(), lpips,
                                      microbatch=LONG_MICROBATCH)
    long_batches = [train_batch(10 + i, LONG_BATCH, HW_LONG) for i in range(2)]
    # The shapes that the steps' autograd gives K5's backward kernels,
    # recorded on the way through (the launch counts stay the wrapper's).
    bwd_shapes = []
    dkv_inner = attention.flash_backward_dkv_cuda

    def capture_dkv(q_, k_, *rest):
        bwd_shapes.append((*q_.shape[:3], k_.shape[2]))
        return dkv_inner(q_, k_, *rest)

    attention.flash_backward_dkv_cuda = capture_dkv
    cuda_lib.reset_launch_counts()
    try:
        long_steps = [run_step(batch, long_train_step)
                      for batch in long_batches]
    finally:
        attention.flash_backward_dkv_cuda = dkv_inner
    long_train_counts = cuda_lib.launches()
    # Each microbatch pass (LONG_BATCH // LONG_MICROBATCH a step, 2 steps)
    # runs the encoder forward once and, under remat, again in the
    # backward; K1/K2 run once per target camera, K3 twice.
    passes = 2 * (LONG_BATCH // LONG_MICROBATCH)
    want = {k: 0 for k in long_train_counts}
    want.update(flash_forward=2 * K5_PER_PASS * passes,
                flash_backward_dkv=K5_PER_PASS * passes,
                flash_backward_dq=K5_PER_PASS * passes,
                composite_forward=2 * LONG_BATCH,
                composite_backward=2 * LONG_BATCH, cumsum_1d=4 * LONG_BATCH)
    if long_train_counts != want:
        fail(f"1024^2 train launch counts {long_train_counts}, expected {want}")
    for st in long_steps:
        emit({"phase": "train_step_1024", "batch": LONG_BATCH,
              "microbatch": LONG_MICROBATCH, **st})
    emit({"phase": "train_1024", "batch": LONG_BATCH,
          "microbatch": LONG_MICROBATCH, "steps": len(long_steps),
          "launches": long_train_counts,
          "step_ms": [st["ms"] for st in long_steps],
          "peak_bytes": max(st["peak_bytes"] for st in long_steps),
          "branches": [st["branch"] for st in long_steps],
          "seconds_total": time.perf_counter() - t_start})
    del long_batches, long_steps
    torch.cuda.empty_cache()
    k5_train = {}
    for shape in dict.fromkeys(bwd_shapes):
        k5_train[shape] = k5_train_shape(torch, attention, shape, gen, dev,
                                         torch.bfloat16)
        emit({"phase": "K5_train", "calls_per_2_steps": bwd_shapes.count(shape),
              **k5_train[shape]})

    # ---- the float32 long-context path (1024^2) -----------------------
    del encoder, optimizer, state, train_step, long_train_step
    gc.collect()
    torch.cuda.empty_cache()
    f32 = f32_phases(torch, dev, request, train_batch, lpips, gen)

    # ---- demo_1024: the demo at 1024^2 ----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    demo_out = demo_phase(torch, repo, dev)

    # ---- 14-18. the command line ---------------------------------------
    del lpips
    gc.collect()
    torch.cuda.empty_cache()
    cli_counts = cli_phases(torch, repo, dev)

    # ---- 19-21. the VGGT-1B family -------------------------------------
    vggt = vggt_phases(torch, repo, dev, request, train_batch)
    gc.collect()
    torch.cuda.empty_cache()
    vggt_cli_counts = vggt_cli_phase(torch, repo, dev)

    # ---- 22-25. SPFSplat v1 ----------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    v1 = v1_phases(torch, repo, dev, request, train_batch)
    gc.collect()
    torch.cuda.empty_cache()
    v1_cli_counts = v1_cli_phase(torch, repo, dev)
    shutil.rmtree(repo / "build" / "cli")
    shutil.rmtree(repo / "build" / "v1", ignore_errors=True)

    # ---- 26-30. the 10-view VGGT preset, utilities, data parallelism ----
    gc.collect()
    torch.cuda.empty_cache()
    v10 = vggt_10view_phase(torch, repo, dev)
    gc.collect()
    torch.cuda.empty_cache()
    par = parallel_phases(torch, repo, dev, v10)
    gc.collect()
    torch.cuda.empty_cache()
    cli_ddp_counts = cli_ddp_phase(torch, repo, dev)

    # ---- 31. a short slice of the flagship overfit recipe ----------------
    gc.collect()
    torch.cuda.empty_cache()
    overfit_counts = overfit_short_phase(torch, repo, dev)
    emit({"phase": "done", "seconds_total": time.perf_counter() - t_start})

    # ---- kernels line, card, result -----------------------------------
    # Launches: each kernel's count over its path: K1-K3 over the training
    # path's 3 steps, K4 over the segscan step, K5's forward over the 3
    # requests at 1024^2 (bf16, or float32 for its float32 kernel), its
    # backward kernels over the 2 train steps at 1024^2; the other paths'
    # counts beside them.  K5's times are those at the encoder's shape
    # (phases "K5" and "K5_f32" have all three); the backward kernels'
    # entries add their times at the train steps' shapes.
    paths = {"serving_3_requests": counts, "align_100_steps": align_counts,
             "ortho_256_render_and_backward": ortho_256["launches"],
             "ortho_1024_render_and_backward": ortho_1024["launches"],
             "train_3_steps": train_counts, "train_segscan_step": segscan_counts,
             "serving_1024_3_requests": long_counts,
             "train_1024_2_steps": long_train_counts,
             "serving_1024_f32_3_requests": f32["serve"],
             "train_1024_f32_2_steps": f32["train"],
             "demo_1024": demo_out["counts"], **cli_counts,
             "vggt_serve_3_requests": vggt["serve"],
             "vggt_train_2_steps": vggt["train"], **vggt_cli_counts,
             "v1_serve_3_requests": v1["serve"],
             "v1_serve_1024_request": v1["serve_1024"],
             "v1_train_2_steps": v1["train"],
             "v1_distill_2_steps": v1["distill"], **v1_cli_counts,
             "vggt_10view_request": v10["serve"],
             "vggt_10view_train_step": v10["train"], **par["paths"],
             **cli_ddp_counts,
             f"overfit_short_{OVERFIT_STEPS}_steps": overfit_counts}

    def by_path(name):
        return {path: c.get(name, 0) for path, c in paths.items()}

    def k5_entries(dtype, results, train_results, serve, train):
        lines = {"forward": 331, "backward_dkv": 796, "backward_dq": 1146}
        entries = []
        for role, name in k5_kernels(attention, dtype).items():
            entry = {
                "name": name, "route": "cuda",
                "source": f"spfsplatv2_tpu_torch/csrc/{name}.cu",
                "replaces": "jax/experimental/pallas/ops/tpu/"
                            f"flash_attention.py:{lines[role]}",
                "launches": (serve if role == "forward" else train)[name],
                "launches_by_path": by_path(name),
                **results["encoder"]["kernels"][name],
                "shape": results["encoder"]["shape"], "dtype": str(dtype),
                "check": {call: {key: c["max_abs_err"] / c["ref_max_abs"]
                                 for key, c in res["vs_plain"].items()}
                          for call, res in results.items()}}
            if role != "forward" or dtype == torch.float32:
                entry["at_train_shapes"] = [
                    {"shape": list(shape), **res["kernels"][name]}
                    for shape, res in train_results.items()]
            entries.append(entry)
        if dtype == torch.float32:
            for name, line, note, launches in (
                    ("flash_f32_split_forward", 331,
                     "the 3xTF32 forward's pre-pass (hi and lo tf32 planes "
                     "of k, and of v transposed); part of the port of the "
                     "forward (:331), its time part of the forward's",
                     serve),
                    ("flash_f32_split", 796,
                     "the 3xTF32 backward pair's pre-pass (hi and lo tf32 "
                     "planes, transposed operands); part of the port of the "
                     "dK/dV (:796) and dQ (:1146) kernels", train)):
                entries.append({
                    "name": name, "route": "cuda",
                    "source": "spfsplatv2_tpu_torch/csrc/flash_f32_split.cu",
                    "replaces": "jax/experimental/pallas/ops/tpu/"
                                f"flash_attention.py:{line}",
                    "note": note, "launches": launches[name],
                    "launches_by_path": by_path(name),
                    **results["encoder"]["kernels"][name],
                    "shape": results["encoder"]["shape"], "dtype": str(dtype),
                    "check": "bit-identical to its plain version, two "
                             "launches",
                    "at_train_shapes": [
                        {"shape": list(shape), **res["kernels"][name]}
                        for shape, res in train_results.items()]})
        return entries

    emit({"kernels": [
        {"name": "composite_forward", "route": "cuda",
         "source": "spfsplatv2_tpu_torch/csrc/composite_forward.cu",
         "replaces": "spfsplatv2_tpu/ops/raster_pallas.py:185",
         "launches": train_counts["composite_forward"],
         "launches_by_path": by_path("composite_forward"), **k1,
         "at_1024_camera": at_1024["composite_forward"],
         "check": {"vs_plain_outlier_pixels": sum(
             v["outliers"] for v in k1_check.values()),
                   "vs_oracle_64px_max_abs_err": max(oracle.values()),
                   "render_1024_vs_plain_max_abs_err": {
                       key: c["max_abs_err"]
                       for key, c in render_check.items()},
                   **{f"render_{o['phase']}_vs_plain_max_abs_err": {
                       key: c["max_abs_err"]
                       for key, c in o["render_vs_plain"].items()}
                      for o in (ortho_256, ortho_1024)},
                   "render_1024_f32_vs_plain_max_abs_err": {
                       key: c["max_abs_err"]
                       for key, c in f32["render_check"].items()},
                   "render_demo_1024_vs_plain_max_abs_err": {
                       key: c["max_abs_err"]
                       for key, c in demo_out["render_check"].items()},
                   "render_vggt_vs_plain_max_abs_err": {
                       key: c["max_abs_err"]
                       for key, c in vggt["render_check"].items()},
                   "render_v1_vs_plain_max_abs_err": {
                       key: c["max_abs_err"]
                       for key, c in v1["render_check"].items()},
                   "tile_shard_1024_bands_vs_single_max_abs_err": {
                       key: c["max_abs_err"]
                       for key, c in par["tile_image"].items()}}},
        {"name": "composite_backward", "route": "cuda",
         "source": "spfsplatv2_tpu_torch/csrc/composite_backward.cu",
         "replaces": "spfsplatv2_tpu/ops/raster_pallas.py:295",
         "launches": train_counts["composite_backward"],
         "launches_by_path": by_path("composite_backward"), **k2,
         "at_1024_camera": at_1024["composite_backward"],
         "check": {"vs_plain_rows_over_1e-4_of_max":
                   k2_check["rows_over_1e-4_of_max"],
                   "vs_oracle_64px_max_abs_err": max(k2_oracle.values()),
                   "camera_1024_vs_plain": k2_long,
                   "ortho_256_backward_vs_plain": ortho_256["k2_vs_plain"],
                   "ortho_1024_backward_vs_plain": ortho_1024["k2_vs_plain"],
                   "train_1024_f32_step_vs_plain": f32["k2_check"],
                   "vggt_train_step_vs_plain": vggt["k2_check"],
                   "v1_train_step_vs_plain": v1["k2_check"],
                   "v1_distill_step_vs_plain": v1["k2_check_distill"],
                   "vggt_10view_step_vs_plain": v10["k2_check"],
                   "tile_shard_1024_summed_grads_vs_single": {
                       key: c["max_abs_err"] / c["max_abs"]
                       for key, c in par["tile_grads"].items()},
                   "ddp_2rank_grad_vs_one_process_share_of_max":
                       par["ddp_grad_err_share"]}},
        {"name": "cumsum_1d", "route": "cuda",
         "source": "spfsplatv2_tpu_torch/csrc/prefix_scan.cu",
         "replaces": "spfsplatv2_tpu/ops/segscan.py:108",
         "launches": train_counts["cumsum_1d"],
         "launches_by_path": by_path("cumsum_1d"), **k3,
         "check": {"int32_exact": all(c["int32_exact"] for c in checks),
                   "f32_max_abs_err": max(c["f32_max_abs_err"]
                                          for c in checks),
                   "int32_exact_on_1024_binning_inputs_n": scan_ns,
                   "int32_exact_on_ortho_binning_inputs_n": [
                       *ortho_256["k3_exact_on_inputs_n"],
                       *ortho_1024["k3_exact_on_inputs_n"]],
                   "int32_exact_on_vggt_binning_inputs_n": vggt["scan_ns"],
                   "int32_exact_on_v1_binning_inputs_n": v1["scan_ns"]}},
        {"name": "segmented_scan", "route": "cuda",
         "source": "spfsplatv2_tpu_torch/csrc/segmented_scan.cu",
         "replaces": "spfsplatv2_tpu/ops/segscan.py:32",
         "launches": segscan_counts["segmented_scan"],
         "launches_by_path": by_path("segmented_scan"), **k4,
         "check": {"vs_plain_within_1e-5_of_running_abs_sum": True}},
        *k5_entries(torch.bfloat16, k5, k5_train, long_counts,
                    long_train_counts),
        *k5_entries(torch.float32, f32["k5"], f32["k5_train"], f32["serve"],
                    f32["train"]),
        {"name": "flash_view_masked", "route": "cuda",
         "source": "spfsplatv2_tpu_torch/csrc/flash_view_masked.cu",
         "replaces": "none: spfsplatv2_tpu/ops/attention.py:sdpa_view_masked "
                     "is plain jnp",
         "launches": v1["serve_1024"]["flash_view_masked"],
         "launches_by_path": by_path("flash_view_masked"),
         **view_masked["v2_views12"],
         "at_shapes": view_masked},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
