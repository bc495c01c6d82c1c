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
// sum_p dpow / op.  Per pixel the kernel sums dpow dx, dpow dy, dpow dx^2,
// dpow dx dy, dpow dy^2, w gC, dpow and w gD; the conic, the -1/2 factors
// and 1/op are applied once per entry to the tile's sums.  The division by
// max(1 - alpha, 1e-6) is a product with its round-to-nearest reciprocal.
//
// K2 re-takes K1's decisions bit for bit (composite_common.cuh): the same
// entries are skipped, and a pixel stops at the same entry (CUDA's
// per-pixel break).  Entries past a pixel's stop, the entry that stops it,
// and skipped entries contribute exact zeros.
//
// Shape: one 256-thread CTA per 16x16 tile, one thread per pixel, each
// warp an 8x4 pixel rectangle; entries staged and culled as in K1 (256 a
// batch when two CTAs an SM hold every tile, else 128, three CTAs an SM),
// the next batch's copies in flight under the walk.  Each warp compacts
// and walks on its own the entries whose cull box meets its rectangle, 6
// a group: their alphas and 1 / (1 - alpha) first, then their steps in
// order, and stops once its 32 pixels have stopped.  The group's entries
// are reduced three at a time: their 30 fields go through one
// reduce-scatter over the 32 lanes (31 shuffles, after which lane l holds
// field l's warp sum) in place of 5 shuffles per field and entry, skipped
// when no lane blends any of the three.  Each warp writes its sums to its
// own slice of shared memory and marks the entries it wrote; after the
// batch's barrier, thread k sums entry k over the marked warps in warp
// order and writes its row to its exclusive slot.  No atomics: reruns give
// the same bits.  Rows of slots no warp blends (past n_live, or after
// every pixel of a tile has stopped) keep the zeros the wrapper allocates.
//
// What bounds it on an H100: like K1, neither memory nor arithmetic.  The
// function reads n_live entries and the two (n_tiles, 256, 8) buffers and
// writes 40 B per slot (~32 MB at 256^2, ~9.4 us at 3.35 TB/s); its work is
// ~65 FP32 operations a blended pair.  What remains is issuing each warp's
// walk over the pairs its rectangle meets (about 3x those that blend) and
// the reductions of the entries it blends, with 16 warps an SM at 256^2,
// and two block barriers a batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace spf;

constexpr int kSlots = 3;  // entries a reduce-scatter takes (30 of 32 lanes)
constexpr int kTriples = 2;  // reduce-scatters a group of the walk

// One pixel's walk state.
struct Pixel {
  float px, py;
  float gr, gg, gb, gd;  // the cotangent of color and depth
  float T, S;
  bool done;
};

// Sum x[i] over the warp's 32 lanes for all 32 i at once: after it, lane
// l's x[0] holds the sum of x[l].  Five butterfly rounds of 16, 8, 4, 2
// and 1 shuffles, each lane keeping the half of its values whose index
// matches its own lane bit; a fixed order, so the sums are deterministic.
// The selects are `selp` on values already in registers, so that no load
// goes through a selected address into x.
__device__ __forceinline__ float select(bool c, float a, float b) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n selp.f32 %0, %1, %2, p;\n}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((int)c));
  return r;
}

// One round: lanes that differ in bit O swap the halves they do not keep.
template <int O>
__device__ __forceinline__ void butterfly(float (&x)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float lo = x[i], hi = x[i + O];
    x[i] = select(upper, hi, lo) +
           __shfl_xor_sync(kFull, select(upper, lo, hi), O);
  }
}

// Each round's width is a template argument, so that every index of x is
// a constant and x stays in registers.
__device__ __forceinline__ void reduce_scatter(float (&x)[32], int lane) {
  butterfly<16>(x, lane);
  butterfly<8>(x, lane);
  butterfly<4>(x, lane);
  butterfly<2>(x, lane);
  butterfly<1>(x, lane);
}

// Reduce a triple's fields (slot k holds entry e[k]'s ten in x[10 k ..],
// e[k] = -1 where no lane blends the entry) over the warp and write each
// sum to the warp's partials; lane 0 marks the entries.
__device__ __forceinline__ void flush(float (&x)[32], const int (&e)[kSlots],
                                      int lane, float* part,
                                      uint32_t* marks) {
  reduce_scatter(x, lane);
  const int ent = lane < 10 ? e[0] : lane < 20 ? e[1] : e[2];
  if (lane < kSlots * kFields && ent >= 0)
    part[ent * kFields + lane % kFields] = x[0];
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      if (e[k] >= 0) marks[e[k] >> 5] |= 1u << (e[k] & 31);
  }
}

// Entry j's step at this pixel: takes its blend (T, S) when the pixel
// keeps it and has not stopped, and writes the ten per-pixel terms of its
// gradient sums to v (zeros otherwise).  Returns whether it blended.
__device__ __forceinline__ bool blend_terms(const Batch& s, int j, bool keep,
                                            float alpha, float inv, Pixel& q,
                                            float* v) {
#pragma unroll
  for (int f = 0; f < kFields; ++f) v[f] = 0.0f;
  if (q.done || !keep) return false;
  const float test_T = next_T(q.T, alpha);
  if (test_T < kTEps) {
    q.done = true;
    return false;
  }
  const float4 geo = s.geo[j], col = s.col[j];
  const float2 gbv = s.gb[j];
  const float dx = __fsub_rn(q.px, geo.x);
  const float dy = __fsub_rn(q.py, geo.y);
  const float w = alpha * q.T;
  const float u = col.y * q.gr + gbv.x * q.gg + gbv.y * q.gb + col.w * q.gd;
  q.S -= w * u;
  const float dalpha = q.T * u - q.S * inv;
  const float dpow = alpha < kAlphaMax ? alpha * dalpha : 0.0f;
  const float ex = dpow * dx, ey = dpow * dy;
  v[0] = ex;
  v[1] = ey;
  v[2] = ex * dx;
  v[3] = ex * dy;
  v[4] = ey * dy;
  v[5] = w * q.gr;
  v[6] = w * q.gg;
  v[7] = w * q.gb;
  v[8] = dpow;
  v[9] = w * q.gd;
  q.T = test_T;
  return true;
}

// Indices list[g .. g + 5] (g even: three 4-byte loads).
__device__ __forceinline__ void triple_indices(const uint16_t* list, int g,
                                               int (&j)[6]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(list + g);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t v = w[i];
    j[2 * i] = (int)(v & 0xffffu);
    j[2 * i + 1] = (int)(v >> 16);
  }
}

template <int kBatch>
struct Smem {
  static constexpr int kMaskWords = kBatch / 32;
  static constexpr int kStage = 2 * kBatch * kEntryBytes;
  static constexpr int kPart = kWarps * kBatch * kFields * 4;
  static constexpr int kLists = kWarps * list_capacity(kBatch) * 2;
  static constexpr int kBytes =
      kStage + kLists + kPart + kWarps * kMaskWords * 4;
};

template <int kBatch, int kMinBlocks>
__global__ void __launch_bounds__(kPix, kMinBlocks)
composite_backward_kernel(const float* __restrict__ packed,
                          const int32_t* __restrict__ src,
                          const int32_t* __restrict__ counts,
                          const int32_t* __restrict__ starts, int tiles_x,
                          const float* __restrict__ fwd_out,
                          const float* __restrict__ grad_out,
                          float* __restrict__ drows) {
  using L = Smem<kBatch>;
  constexpr int kPerThread = (kBatch + kPix - 1) / kPix;
  extern __shared__ __align__(16) unsigned char smem[];
  auto buffer = [&](int b) {
    return batch_at(smem + b * kBatch * kEntryBytes, kBatch);
  };
  // part[w][k * 10 + f]: warp w's sum of field f of entry k; marks[w]: the
  // entries warp w wrote.
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + L::kStage) +
                   (threadIdx.x >> 5) * list_capacity(kBatch);
  float* part = reinterpret_cast<float*>(smem + L::kStage + L::kLists);
  uint32_t* marks = reinterpret_cast<uint32_t*>(smem + L::kStage + L::kLists +
                                                L::kPart);

  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = rect_x0(warp), y0 = rect_y0(warp);
  const int p = lane_pixel(warp, lane);
  const float ox = (float)((tile % tiles_x) * kTile);
  const float oy = (float)((tile / tiles_x) * kTile);
  const int start = starts[tile];
  const int count = counts[tile];

  Pixel q;
  q.px = (float)(p % kTile);
  q.py = (float)(p / kTile);
  const int64_t pix = ((int64_t)tile * kPix + p) * 8;
  const float4 f0 = reinterpret_cast<const float4*>(fwd_out + pix)[0];
  const float4 f1 = reinterpret_cast<const float4*>(fwd_out + pix)[1];
  const float4 g0 = reinterpret_cast<const float4*>(grad_out + pix)[0];
  const float4 g1 = reinterpret_cast<const float4*>(grad_out + pix)[1];
  q.gr = g0.x;
  q.gg = g0.y;
  q.gb = g0.z;
  q.gd = g0.w;
  // phi = C . gC + D gD + T_fin (gT - gA); S starts at phi.
  q.S = f0.x * q.gr + f0.y * q.gg + f0.z * q.gb + f0.w * q.gd +
        f1.y * (g1.y - g1.x);
  q.T = 1.0f;
  q.done = false;

  float* my_part = part + warp * kBatch * kFields;
  uint32_t* my_marks = marks + warp * L::kMaskWords;

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
    for (int i = lane; i < L::kMaskWords; i += 32) my_marks[i] = 0u;
    const int len = build_list(s, n, x0, y0, lane, list);
    for (int g = 0; g < len && !__all_sync(kFull, q.done);
         g += kTriples * kSlots) {
      int j[kTriples * kSlots];
      triple_indices(list, g, j);
      // The group's alphas (and 1 / (1 - alpha)) first, then its entries
      // in order, three to a reduce-scatter.
      float al[kTriples * kSlots], inv[kTriples * kSlots];
      bool keep[kTriples * kSlots];
#pragma unroll
      for (int i = 0; i < kTriples * kSlots; ++i) {
        float dx, dy;
        keep[i] = entry_alpha(s.geo[j[i]], s.col[j[i]], q.px, q.py, &dx,
                              &dy, &al[i]) &&
                  g + i < len;
        inv[i] = __frcp_rn(fmaxf(1.0f - al[i], 1e-6f));
      }
#pragma unroll
      for (int h = 0; h < kTriples; ++h) {
        float x[32];
        int e[kSlots];
        bool any = false;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const int i = h * kSlots + k;
          const bool blended = blend_terms(s, j[i], keep[i], al[i], inv[i],
                                           q, &x[k * kFields]);
          e[k] = __any_sync(kFull, blended) ? j[i] : -1;
          any = any || e[k] >= 0;
        }
        x[30] = 0.0f;
        x[31] = 0.0f;
        if (any) flush(x, e, lane, my_part, my_marks);
      }
    }
    if (n_next > 0) batch_finish<kPerThread>(buffer(b ^ 1), n_next, ox, oy);
    __syncthreads();
    // Sum the marked warps' partials in warp order; thread k writes
    // entry k's row.
    for (int k = threadIdx.x; k < n; k += kPix) {
      float acc[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) acc[f] = 0.0f;
      bool any = false;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if ((marks[w * L::kMaskWords + (k >> 5)] >> (k & 31)) & 1u) {
          any = true;
          const float* pw = part + (w * kBatch + k) * kFields;
#pragma unroll
          for (int f = 0; f < kFields; ++f) acc[f] += pw[f];
        }
      }
      if (!any) continue;
      const float4 geo = s.geo[k], col = s.col[k];
      float* row = drows + (int64_t)(start + base + k) * kFields;
      row[0] = geo.z * acc[0] + geo.w * acc[1];
      row[1] = col.x * acc[1] + geo.w * acc[0];
      row[2] = -0.5f * acc[2];
      row[3] = -acc[3];
      row[4] = -0.5f * acc[4];
      row[5] = acc[5];
      row[6] = acc[6];
      row[7] = acc[7];
      row[8] = acc[8] / fmaxf(col.z, 1e-9f);
      row[9] = acc[9];
    }
    // Before the next batch's walk overwrites the partials, and the
    // block's exit test.
    if (__syncthreads_count(!q.done) == 0) break;
  }
}

template <int kBatch, int kMinBlocks>
int launch(const float* packed, const int32_t* src, const int32_t* counts,
           const int32_t* starts, int n_tiles, int tiles_x,
           const float* fwd_out, const float* grad_out, float* drows,
           cudaStream_t stream) {
  static uint64_t raised = 0;
  constexpr int smem = Smem<kBatch>::kBytes;
  auto kernel = composite_backward_kernel<kBatch, kMinBlocks>;
  cudaError_t err = allow_smem(kernel, smem, raised);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_tiles, kPix, smem, stream>>>(packed, src, counts, starts,
                                          tiles_x, fwd_out, grad_out, drows);
  return (int)cudaGetLastError();
}

// The SMs of the current device, or 0 if the query fails (the error then
// comes back from the C entry point).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

}  // namespace

// packed (g, 10) f32 (8-byte aligned), src (e_pad,) i32, counts/starts
// (n_tiles,) i32, fwd_out and grad_out (n_tiles, 256, 8) f32, drows (e_pad,
// 10) f32 zero-filled by the caller; all contiguous on the current device.
extern "C" int spf_composite_backward(const void* packed, const void* src,
                                      const void* counts, const void* starts,
                                      int n_tiles, int tiles_x,
                                      const void* fwd_out,
                                      const void* grad_out, void* drows,
                                      void* stream) {
  if (n_tiles <= 0) return (int)cudaGetLastError();
  const auto* p = static_cast<const float*>(packed);
  const auto* s = static_cast<const int32_t*>(src);
  const auto* c = static_cast<const int32_t*>(counts);
  const auto* o = static_cast<const int32_t*>(starts);
  const auto* f = static_cast<const float*>(fwd_out);
  const auto* g = static_cast<const float*>(grad_out);
  auto* d = static_cast<float*>(drows);
  auto st = static_cast<cudaStream_t>(stream);
  // Batches of 256 when two CTAs an SM hold every tile (fewer barriers),
  // else of 128, so that three CTAs share an SM.
  if (n_tiles <= 2 * sm_count())
    return launch<256, 2>(p, s, c, o, n_tiles, tiles_x, f, g, d, st);
  return launch<128, 3>(p, s, c, o, n_tiles, tiles_x, f, g, d, st);
}
