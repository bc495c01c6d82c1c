// K1: per-tile front-to-back alpha compositing over the prefix layout.
//
// Replaces the Pallas TPU kernel
// spfsplatv2_tpu/ops/raster_pallas.py:_forward_kernel (launched by _fwd_call
// from _prefix_core).  Tile t composites entries [starts[t], starts[t] +
// counts[t]) of the depth-sorted slot space; entry e reads Gaussian row
// src[e] of `packed` (g, 10) = [mx, my, conic a, b, c, r, g, b, opacity,
// depth].  The `rows = packed[src]` gather of _prefix_core is fused here.
//
// Output (n_tiles, 256, 8) per pixel: [r, g, b, depth, 1 - T, T, 0, 0];
// the caller adds the background.  Semantics are those of the CUDA 3DGS
// rasterizer: power = -0.5 (a dx^2 + c dy^2) - b dx dy is skipped when
// > 0, alpha = min(0.99, op * exp(power)) is skipped below 1/255, and a
// pixel stops for good at the first entry whose T * (1 - alpha) < 1e-4.
//
// Shape: one 256-thread CTA per 16x16 tile, one thread per pixel.  The
// TPU kernel DMAs (16, chunk) attribute blocks and evaluates a (256 x
// chunk) alpha matrix on the MXU; here entries are staged through shared
// memory in batches of 256 (each thread gathers one entry's 10 fields, 10
// KB a batch), then every thread walks the batch in order.  The block
// exits once no pixel is live (__syncthreads_count).
//
// Precision: FP32 FMA and expf (no --use_fast_math, no __expf).  A lower
// precision exponent flips entries across the alpha cut-offs.  Coordinates
// are tile-local (mean minus tile origin, as _pixel_grid explains) so
// dx, dy stay small.
//
// What bounds it on an H100: neither memory nor arithmetic at this size.
// It must read n_live entries (44 B each with the index) and write 2 MiB
// at 256^2, a few microseconds at 3.35 TB/s; the work is ~30 FP32 ops per
// evaluated (pixel, entry) pair.  A 256^2 camera has only 256 tiles, under
// two waves on 132 SMs, and the per-pixel loop is serial, so latency of
// the dependent T chain dominates.  Splitting tiles across CTAs, wgmma for
// the exponent and TMA staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kFields = 10;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPix)
composite_forward_kernel(const float* __restrict__ packed,
                         const int32_t* __restrict__ src,
                         const int32_t* __restrict__ counts,
                         const int32_t* __restrict__ starts, int tiles_x,
                         float* __restrict__ out) {
  __shared__ float s_mx[kPix], s_my[kPix], s_ca[kPix], s_cb[kPix],
      s_cc[kPix], s_r[kPix], s_g[kPix], s_b[kPix], s_op[kPix], s_z[kPix];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float ox = (float)((tile % tiles_x) * kTile);
  const float oy = (float)((tile / tiles_x) * kTile);
  const float px = (float)(p % kTile);
  const float py = (float)(p / kTile);
  const int start = starts[tile];
  const int count = counts[tile];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, depth = 0.0f;
  bool done = false;

  for (int base = 0; base < count; base += kPix) {
    const int n = min(kPix, count - base);
    if (p < n) {
      const float* row = packed + (int64_t)src[start + base + p] * kFields;
      s_mx[p] = row[0] - ox;
      s_my[p] = row[1] - oy;
      s_ca[p] = row[2];
      s_cb[p] = row[3];
      s_cc[p] = row[4];
      s_r[p] = row[5];
      s_g[p] = row[6];
      s_b[p] = row[7];
      s_op[p] = row[8];
      s_z[p] = row[9];
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        const float dx = px - s_mx[j];
        const float dy = py - s_my[j];
        const float power =
            -0.5f * (s_ca[j] * dx * dx + s_cc[j] * dy * dy) - s_cb[j] * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(kAlphaMax, s_op[j] * expf(power));
        if (alpha < kAlphaMin) continue;
        const float test_T = T * (1.0f - alpha);
        if (test_T < kTEps) {
          done = true;
          break;
        }
        const float w = alpha * T;
        cr += w * s_r[j];
        cg += w * s_g[j];
        cb += w * s_b[j];
        depth += w * s_z[j];
        T = test_T;
      }
    }
    // Barrier before the next batch overwrites shared memory, and the
    // block's exit test.
    if (__syncthreads_count(!done) == 0) break;
  }

  float4* o = reinterpret_cast<float4*>(out + ((int64_t)tile * kPix + p) * 8);
  o[0] = make_float4(cr, cg, cb, depth);
  o[1] = make_float4(1.0f - T, T, 0.0f, 0.0f);
}

}  // namespace

// packed (g, 10) f32, src (e_pad,) i32, counts/starts (n_tiles,) i32,
// out (n_tiles, 256, 8) f32; all contiguous on the current device.
extern "C" int spf_composite_forward(const void* packed, const void* src,
                                     const void* counts, const void* starts,
                                     int n_tiles, int tiles_x, void* out,
                                     void* stream) {
  if (n_tiles > 0) {
    composite_forward_kernel<<<n_tiles, kPix, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(starts), tiles_x,
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
