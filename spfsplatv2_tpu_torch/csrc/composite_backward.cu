// K2: per-entry gradients of the per-tile front-to-back compositing.
//
// Replaces the Pallas TPU kernel
// spfsplatv2_tpu/ops/raster_pallas.py:_backward_kernel (launched by _bwd_call
// from _prefix_core_bwd).  Given K1's saved output (n_tiles, 256, 8) =
// [r, g, b, depth, 1 - T, T, 0, 0] and its cotangent g (same shape), it
// writes one gradient row per entry slot, drows (e_pad, 10) = d[mx, my,
// conic a, b, c, r, g, b, opacity, depth], in slot order.  The caller
// reduces the rows per Gaussian (index_add_ or the segmented scan, K4).
//
// The suffix identity of the TPU kernel (raster_pallas.py:28-38) makes one
// front-to-back walk enough, with no back-to-front pass:
//   dL/dalpha_i = T_i u_i - S_i / max(1 - alpha_i, 1e-6),
//   S_i = phi - sum_{j<=i} w_j u_j,  u_i = rgb_i . gC + z_i gD,
//   phi = C . gC + D gD + T_fin (gT - gA),
// where w_i = alpha_i T_i.  Unlike the TPU kernel's caller, which drops the
// cotangent of the T channel, phi takes gT: the background term
// T_fin * background of the caller's color is differentiated too.  An entry
// clamped at alpha >= 0.99 gets zero power gradient; d opacity is
// sum_p dpow / op.
//
// K2 re-takes K1's decisions bit for bit (composite_common.cuh): the same
// entries are skipped, and a pixel stops at the same entry (CUDA's
// per-pixel break).  Entries past a pixel's stop, the entry that stops it,
// and skipped entries contribute exact zeros.
//
// Shape: one 256-thread CTA per 16x16 tile, one thread per pixel, entries
// staged through shared memory in rounds of 128.  Each entry's 10 fields
// are summed over the tile's 256 pixels with warp shuffles (a warp none of
// whose pixels touches the entry skips them), then over the 8 warps
// through shared memory, and thread k writes entry k's row to its
// exclusive slot: no atomics, so the result is deterministic.  Rows of
// slots that no CTA reaches (past n_live, or after every pixel of a tile
// has stopped) keep the zeros the wrapper allocates.
//
// What bounds it on an H100: like K1, neither memory nor arithmetic at the
// flagship size.  The function reads n_live entries and the two (n_tiles,
// 256, 8) buffers and writes 40 B per slot (~21 MB at e_pad = 524416, ~6 us
// at 3.35 TB/s); the arithmetic is ~30 FP32 ops per walked pair and ~40 per
// blended pair plus 50 shuffles per (warp, entry) that a warp touches.
// The serial per-pixel walk over 256 tiles on 132 SMs and the per-entry
// shuffle reductions set its time; a split of long segments across CTAs
// and reducing several entries per shuffle round are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace spf;

constexpr int kBatch = 128;  // entries staged per round
constexpr int kWarps = kPix / 32;

__global__ void __launch_bounds__(kPix)
composite_backward_kernel(const float* __restrict__ packed,
                          const int32_t* __restrict__ src,
                          const int32_t* __restrict__ counts,
                          const int32_t* __restrict__ starts, int tiles_x,
                          const float* __restrict__ fwd_out,
                          const float* __restrict__ grad_out,
                          float* __restrict__ drows) {
  __shared__ Staged<kBatch> s;                        // 5 KB
  __shared__ float s_part[kWarps][kBatch][kFields];   // 40 KB

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float ox = (float)((tile % tiles_x) * kTile);
  const float oy = (float)((tile / tiles_x) * kTile);
  const float px = (float)(p % kTile);
  const float py = (float)(p / kTile);
  const int start = starts[tile];
  const int count = counts[tile];

  const int64_t pix = ((int64_t)tile * kPix + p) * 8;
  const float4 f0 = reinterpret_cast<const float4*>(fwd_out + pix)[0];
  const float4 f1 = reinterpret_cast<const float4*>(fwd_out + pix)[1];
  const float4 g0 = reinterpret_cast<const float4*>(grad_out + pix)[0];
  const float4 g1 = reinterpret_cast<const float4*>(grad_out + pix)[1];
  const float gr = g0.x, gg = g0.y, gb = g0.z, gd = g0.w;
  // phi = C . gC + D gD + T_fin (gT - gA); S starts at phi.
  float S = f0.x * gr + f0.y * gg + f0.z * gb + f0.w * gd + f1.y * (g1.y - g1.x);
  float T = 1.0f;
  bool done = false;

  for (int base = 0; base < count; base += kBatch) {
    const int n = min(kBatch, count - base);
    if (p < n) stage_entry(s, p, packed, src[start + base + p], ox, oy);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float v[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) v[f] = 0.0f;
      bool blended = false;
      float dx, dy, alpha;
      if (!done && entry_alpha(s, j, px, py, &dx, &dy, &alpha)) {
        const float test_T = next_T(T, alpha);
        if (test_T < kTEps) {
          done = true;
        } else {
          const float w = alpha * T;
          const float u = s.r[j] * gr + s.g[j] * gg + s.b[j] * gb + s.z[j] * gd;
          S -= w * u;
          const float dalpha = T * u - S / fmaxf(1.0f - alpha, 1e-6f);
          const float dpow = alpha < kAlphaMax ? alpha * dalpha : 0.0f;
          const float ca = s.ca[j], cb = s.cb[j], cc = s.cc[j];
          v[0] = dpow * (ca * dx + cb * dy);
          v[1] = dpow * (cc * dy + cb * dx);
          v[2] = -0.5f * dpow * dx * dx;
          v[3] = -dpow * dx * dy;
          v[4] = -0.5f * dpow * dy * dy;
          v[5] = w * gr;
          v[6] = w * gg;
          v[7] = w * gb;
          v[8] = dpow / fmaxf(s.op[j], 1e-9f);
          v[9] = w * gd;
          T = test_T;
          blended = true;
        }
      }
      // Sum over the warp's 32 pixels; the branch is warp-uniform.
      if (__any_sync(0xffffffffu, blended)) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[f] += __shfl_down_sync(0xffffffffu, v[f], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kFields; ++f) s_part[warp][j][f] = v[f];
      }
    }
    __syncthreads();
    // Sum the 8 warps' partials; thread k writes entry k's row.
    if (p < n) {
      float* row = drows + (int64_t)(start + base + p) * kFields;
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += s_part[w][p][f];
        row[f] = acc;
      }
    }
    // Barrier before the next round overwrites shared memory, and the
    // block's exit test.
    if (__syncthreads_count(!done) == 0) break;
  }
}

}  // namespace

// packed (g, 10) f32, src (e_pad,) i32, counts/starts (n_tiles,) i32,
// fwd_out and grad_out (n_tiles, 256, 8) f32, drows (e_pad, 10) f32
// zero-filled by the caller; all contiguous on the current device.
extern "C" int spf_composite_backward(const void* packed, const void* src,
                                      const void* counts, const void* starts,
                                      int n_tiles, int tiles_x,
                                      const void* fwd_out,
                                      const void* grad_out, void* drows,
                                      void* stream) {
  if (n_tiles > 0) {
    composite_backward_kernel<<<n_tiles, kPix, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(starts), tiles_x,
        static_cast<const float*>(fwd_out),
        static_cast<const float*>(grad_out), static_cast<float*>(drows));
  }
  return (int)cudaGetLastError();
}
