"""PyTorch/CUDA port of `spfsplatv2_tpu`, one slice at a time.

The package mirrors the JAX package's layout and module names so that
each module's counterpart is found at the same path.  It imports torch
and numpy only; nothing of JAX or of `spfsplatv2_tpu`.

Conventions kept from the JAX package at every public function: NHWC
images, `(b, v, ...)` batches, `(g, ...)` Gaussian tables, int32 bin
fields, and the bf16 backbone compute with float32 LayerNorms.  Entry
points run on `cuda` unless the caller passes `device="cpu"`.

The rasterizer's hand-written CUDA kernels live in `csrc/`; they are
built with `nvcc` into `build/kernels/` at first use
(`ops/cuda_lib.py`).
"""
