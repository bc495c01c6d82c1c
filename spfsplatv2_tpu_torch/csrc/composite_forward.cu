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
// Shape: one 256-thread CTA per 16x16 tile, one thread per pixel, each
// warp an 8x4 pixel rectangle (composite_common.cuh).  The TPU kernel DMAs
// (16, chunk) attribute blocks and evaluates a (256 x chunk) alpha matrix
// on the MXU.  Here the tile's entries are gathered with cp.async into
// double-buffered batches of 512 in dynamic shared memory (53 KB, three
// CTAs an SM), the next batch's copies in flight under the current
// batch's walk.  Each staged entry gets its cull box
// once.  Each warp compacts the entries whose box meets its rectangle into
// its own list and walks it on its own (one block barrier a batch), 8
// entries a group: their alphas first, independent of one another, then
// their blends in order, branch-free.  It stops walking once its 32
// pixels have stopped, and the block stops staging once all 256 have
// (__syncthreads_count).
//
// Precision: the alpha and transmittance arithmetic lives in
// composite_common.cuh, shared with K2 (composite_backward.cu), in explicit
// round-to-nearest FP32 with expf (no --use_fast_math, no __expf): K2 must
// re-take K1's skip and stop decisions bit for bit, and a lower precision
// exponent flips entries across the alpha cut-offs.  Each sum takes w * x
// + sum (one FMA) as in the first, unculled version of this kernel, whose
// output this one reproduces bit for bit; the cull skips only pairs that
// the exact test skips.  Coordinates are tile-local (mean minus tile
// origin, as _pixel_grid explains) so dx, dy stay small.
//
// What bounds it on an H100: neither memory nor arithmetic.  It must read
// n_live entries (44 B each with the index) and write 2 MiB at 256^2, ~2.5
// us at 3.35 TB/s, and its needed work is ~25 FP32 operations a blended
// pair, less still.  What remains is issuing each warp's walk (the box
// tests, and the power, expf and blend of every pair its rectangle meets,
// about 3x the pairs that blend) with few warps to hide latency: at 256^2
// only 256 tiles, 16 warps an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace spf;

constexpr int kBatch = 512;  // records a staged batch
constexpr int kGroup = 8;    // records a group of the walk

// The group's 8 record indices, list[g .. g + 7], g a multiple of 8.
__device__ __forceinline__ void group_indices(const uint16_t* list, int g,
                                              int (&j)[kGroup]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(list + g);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    j[2 * i] = (int)(w[i] & 0xffffu);
    j[2 * i + 1] = (int)(w[i] >> 16);
  }
}

__global__ void __launch_bounds__(kPix, 3)
composite_forward_kernel(const float* __restrict__ packed,
                         const int32_t* __restrict__ src,
                         const int32_t* __restrict__ counts,
                         const int32_t* __restrict__ starts, int tiles_x,
                         float* __restrict__ out) {
  constexpr int kPerThread = kBatch / kPix;
  extern __shared__ __align__(16) unsigned char smem[];
  auto buffer = [&](int b) {
    return batch_at(smem + b * kBatch * kEntryBytes, kBatch);
  };

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = rect_x0(warp), y0 = rect_y0(warp);
  const int p = lane_pixel(warp, lane);
  const float ox = (float)((tile % tiles_x) * kTile);
  const float oy = (float)((tile / tiles_x) * kTile);
  const float px = (float)(p % kTile);
  const float py = (float)(p / kTile);
  uint16_t* list =
      reinterpret_cast<uint16_t*>(smem + 2 * kBatch * kEntryBytes) +
      warp * list_capacity(kBatch);
  const int start = starts[tile];
  const int count = counts[tile];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, depth = 0.0f;
  bool done = false;       // this pixel has stopped
  bool warp_done = false;  // all 32 of the warp's pixels have

  int32_t idx[kPerThread];
  if (count > 0) {
    batch_indices(src, start, min(kBatch, count), idx);
    batch_issue(buffer(0), min(kBatch, count), packed, idx);
    if (count > kBatch)
      batch_indices(src, start + kBatch, min(kBatch, count - kBatch), idx);
    batch_finish<kPerThread>(buffer(0), min(kBatch, count), ox, oy);
  }
  __syncthreads();

  for (int base = 0, b = 0; base < count; base += kBatch, b ^= 1) {
    const Batch s = buffer(b);
    const int n = min(kBatch, count - base);
    const int next = base + kBatch;
    const int n_next = min(kBatch, count - next);
    if (n_next > 0) {
      batch_issue(buffer(b ^ 1), n_next, packed, idx);
      if (next + kBatch < count)
        batch_indices(src, start + next + kBatch,
                      min(kBatch, count - next - kBatch), idx);
    }
    if (!warp_done) {
      const int len = build_list(s, n, x0, y0, lane, list);
      for (int g = 0; g < len; g += kGroup) {
        int j[kGroup];
        group_indices(list, g, j);
        // The group's alphas first, then its blends in order.
        float al[kGroup];
        bool keep[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          float dx, dy;
          keep[i] = entry_alpha(s.geo[j[i]], s.col[j[i]], px, py, &dx, &dy,
                                &al[i]) &&
                    g + i < len;
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          // Branch-free: each sum takes its new value only where the
          // entry blends.
          const float4 col = s.col[j[i]];
          const float2 gb = s.gb[j[i]];
          const float test_T = next_T(T, al[i]);
          const bool take = !done && keep[i];
          const bool blend = take && !(test_T < kTEps);
          done = done || (take && test_T < kTEps);
          const float w = al[i] * T;
          cr = blend ? cr + w * col.y : cr;
          cg = blend ? cg + w * gb.x : cg;
          cb = blend ? cb + w * gb.y : cb;
          depth = blend ? depth + w * col.w : depth;
          T = blend ? test_T : T;
        }
        if (__all_sync(kFull, done)) {
          warp_done = true;
          break;
        }
      }
    }
    if (n_next > 0) batch_finish<kPerThread>(buffer(b ^ 1), n_next, ox, oy);
    // Publishes the next batch, frees this one, and is the block's exit
    // test.
    if (__syncthreads_count(!done) == 0) break;
  }

  float4* o = reinterpret_cast<float4*>(out + ((int64_t)tile * kPix + p) * 8);
  o[0] = make_float4(cr, cg, cb, depth);
  o[1] = make_float4(1.0f - T, T, 0.0f, 0.0f);
}

}  // namespace

// packed (g, 10) f32 (8-byte aligned), src (e_pad,) i32, counts/starts
// (n_tiles,) i32, out (n_tiles, 256, 8) f32; all contiguous on the current
// device.
extern "C" int spf_composite_forward(const void* packed, const void* src,
                                     const void* counts, const void* starts,
                                     int n_tiles, int tiles_x, void* out,
                                     void* stream) {
  if (n_tiles <= 0) return (int)cudaGetLastError();
  static uint64_t raised = 0;
  const int smem = 2 * kBatch * kEntryBytes +
                   kWarps * list_capacity(kBatch) * (int)sizeof(uint16_t);
  const cudaError_t err =
      allow_smem(composite_forward_kernel, smem, raised);
  if (err != cudaSuccess) return (int)err;
  composite_forward_kernel<<<n_tiles, kPix, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int32_t*>(src),
      static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(starts), tiles_x,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
