// Per-(pixel, entry) arithmetic, staging and culling shared by K1
// (composite_forward.cu) and K2 (composite_backward.cu).
//
// K2 re-walks K1's entries and must take exactly K1's decisions: which
// entries are skipped (power > 0, alpha < 1/255) and where each pixel
// stops (T * (1 - alpha) < 1e-4).  Both kernels therefore stage entries
// with `stage_issue` / `stage_finish` and evaluate them with `entry_alpha`
// / `next_T`, written with explicit round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never contracts into FMAs:
// the same inputs give the same bits in both kernels whatever code
// surrounds the call.  Both files are built with the same flags (no
// --use_fast_math; expf, not __expf).
//
// Culling.  `cull_box` gives each staged entry the pixels of its tile
// outside of which `entry_alpha` skips it: a pixel keeps an entry only
// when op * exp(power) >= 1/255, i.e. when q = a dx^2 + 2 b dx dy + c dy^2
// <= t = 2 ln(255 op), an ellipse whose axis-aligned box has half-extents
// sqrt(t c / det) and sqrt(t a / det), det = a c - b^2.  The box is
// inflated for float32 rounding (see the constants) and each of a tile's
// warps walks only the entries whose box meets its own pixel rectangle,
// so the cull removes only pairs that the exact test skips: the kernels'
// outputs do not depend on it.  `ops/raster_cuda.py:cull_box_plain` is the
// same predicate in PyTorch, which the CPU tests hold against the exact
// skip test.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace spf {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;
constexpr int kFields = 10;  // [mx, my, conic a, b, c, r, g, b, opacity, depth]
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

// Each warp owns an 8 x 4 pixel rectangle of the tile: warp w covers
// x in [8 (w % 2), +8), y in [4 (w / 2), +4); lane l is pixel
// (x0 + l % 8, y0 + l / 8).  The output keeps the p = y * 16 + x layout.
constexpr int kRectW = 8, kRectH = 4;

__device__ __forceinline__ int rect_x0(int warp) { return (warp & 1) * kRectW; }
__device__ __forceinline__ int rect_y0(int warp) { return (warp >> 1) * kRectH; }
__device__ __forceinline__ int lane_pixel(int warp, int lane) {
  return (rect_y0(warp) + lane / kRectW) * kTile + rect_x0(warp) +
         lane % kRectW;
}

// ---- the cull box -----------------------------------------------------
//
// Margins, for float32 rounding of the kernel's power (about 4 ulp of
// M = (a dx^2 + c dy^2) / 2 + |b dx dy| <= q / (1 - rho), rho = |b| /
// sqrt(a c)), of expf (2 ulp), of t and det, and of dx = px - mx:
// - cull only a well-conditioned conic: det > kCullDetMin a c bounds
//   1 - rho below by ~5e-5, so the power's error is under 1% of q;
// - t is raised by 1/64 of itself and 2^-16 (covers the 1% and expf);
// - each half-extent by 1/128 of itself and 1/1024 pixel (covers det's
//   relative error, ~1.2e-3 at that conditioning, and dx's rounding).
// Anything else (not finite, not positive definite, ill-conditioned, or
// large enough that the power could overflow) keeps the whole tile.  An
// entry with op < 0.999 / 255 (and finite power) is skipped at every
// pixel: expf rounds within 2 ulp, so just under 1/255 an entry may still
// be kept where power is ~0, which the t >= 0 box then holds.
constexpr float kCullOpMin = 0.999f * kAlphaMin;
constexpr float kCullDetMin = 1e-4f;
constexpr float kCullACMin = 1e-30f;       // a c stays a normal float
constexpr float kCullQuadMax = 1e36f;      // max(a, c) (|m| + 16)^2 bound
constexpr float kCullTRel = 1.0f + 1.0f / 64.0f;
constexpr float kCullTAbs = 1.0f / 65536.0f;
constexpr float kCullExtRel = 1.0f + 1.0f / 128.0f;
constexpr float kCullExtAbs = 1.0f / 1024.0f;

// A box is four bytes: x_lo | x_hi << 8 | y_lo << 16 | y_hi << 24, tile
// pixels inclusive.  Empty: x_lo = 255, which meets no rectangle.
constexpr uint32_t kBoxEmpty = 0xffu;
constexpr uint32_t kBoxTile = (15u << 8) | (15u << 24);

// Pixel range [lo, hi] of one axis inside [0, 15], or lo > hi.
__device__ __forceinline__ void axis_range(float m, float ext, int* lo,
                                           int* hi) {
  const float a = fminf(fmaxf(m - ext, -1.0f), 16.0f);
  const float b = fminf(fmaxf(m + ext, -1.0f), 16.0f);
  *lo = max((int)ceilf(a), 0);
  *hi = min((int)floorf(b), 15);
}

// |x| <= FLT_MAX: false for infinities and NaN.
__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) <= 3.40282347e38f;
}

// The box of an entry with tile-local mean (mx, my), conic (a, b, c) and
// opacity op.
__device__ __forceinline__ uint32_t cull_box(float mx, float my, float a,
                                             float b, float c, float op) {
  const float ac = a * c;
  const float det = ac - b * b;
  const float r = fmaxf(fabsf(mx), fabsf(my)) + 16.0f;
  const bool all_finite = finite(mx) && finite(my) && finite(b) &&
                          finite(op) && finite(ac) && finite(det);
  // Negated comparisons: a NaN keeps the whole tile.
  if (!(all_finite && a > 0.0f && c > 0.0f && ac >= kCullACMin &&
        det > kCullDetMin * ac && fmaxf(a, c) * r * r < kCullQuadMax))
    return kBoxTile;
  if (op < kCullOpMin) return kBoxEmpty;
  const float t = fmaxf(2.0f * logf(255.0f * op), 0.0f) * kCullTRel + kCullTAbs;
  const float ex = sqrtf(t * c / det) * kCullExtRel + kCullExtAbs;
  const float ey = sqrtf(t * a / det) * kCullExtRel + kCullExtAbs;
  int x_lo, x_hi, y_lo, y_hi;
  axis_range(mx, ex, &x_lo, &x_hi);
  axis_range(my, ey, &y_lo, &y_hi);
  if (x_lo > x_hi || y_lo > y_hi) return kBoxEmpty;
  return (uint32_t)x_lo | ((uint32_t)x_hi << 8) | ((uint32_t)y_lo << 16) |
         ((uint32_t)y_hi << 24);
}

// Does the box meet the rectangle [x0, x0 + 7] x [y0, y0 + 3]?
__device__ __forceinline__ bool box_meets(uint32_t box, int x0, int y0) {
  return (int)(box & 0xff) <= x0 + kRectW - 1 &&
         (int)((box >> 8) & 0xff) >= x0 &&
         (int)((box >> 16) & 0xff) <= y0 + kRectH - 1 &&
         (int)(box >> 24) >= y0;
}

// ---- staging ------------------------------------------------------------
//
// A batch of entries in shared memory, one 44-byte record an entry in four
// arrays: geo = [mx, my, a, b] (the mean tile-local), col = [c, r, op,
// depth], gb = [g, b], and the cull box.  `packed` rows are 40 bytes, so a
// row is gathered as five 8-byte cp.async copies (only every other row is
// 16-byte aligned).
struct Batch {
  float4* geo;
  float4* col;
  float2* gb;
  uint32_t* box;
};

constexpr int kEntryBytes = 16 + 16 + 8 + 4;

__device__ __forceinline__ Batch batch_at(unsigned char* base, int size) {
  Batch s;
  s.geo = reinterpret_cast<float4*>(base);
  s.col = reinterpret_cast<float4*>(base + 16 * size);
  s.gb = reinterpret_cast<float2*>(base + 32 * size);
  s.box = reinterpret_cast<uint32_t*>(base + 40 * size);
  return s;
}

__device__ __forceinline__ void cp_async8(void* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of Gaussian row `row_index` into record k.
__device__ __forceinline__ void stage_issue(const Batch& s, int k,
                                            const float* __restrict__ packed,
                                            int32_t row_index) {
  const float* row = packed + (int64_t)row_index * kFields;
  cp_async8(&s.geo[k].x, row + 0);  // mx, my
  cp_async8(&s.geo[k].z, row + 2);  // a, b
  cp_async8(&s.col[k].x, row + 4);  // c, r
  cp_async8(&s.gb[k], row + 6);     // g, b
  cp_async8(&s.col[k].z, row + 8);  // op, depth
}

// After the issuing thread's copies have landed (cp_async_wait_all): make
// record k's mean tile-local and give it its box.
__device__ __forceinline__ void stage_finish(const Batch& s, int k, float ox,
                                             float oy) {
  float4 g = s.geo[k];
  const float4 c = s.col[k];
  g.x = __fsub_rn(g.x, ox);
  g.y = __fsub_rn(g.y, oy);
  s.geo[k] = g;
  s.box[k] = cull_box(g.x, g.y, g.z, g.w, c.x, c.z);
}

// Stage entries [base, base + n) of a tile's segment: thread t handles
// records t, t + kPix, ...; each record's copies are issued by the thread
// that finishes it.  `idx` holds the row indices (read ahead by the
// caller).
template <int PerThread>
__device__ __forceinline__ void batch_issue(const Batch& s, int n,
                                            const float* __restrict__ packed,
                                            const int32_t (&idx)[PerThread]) {
#pragma unroll
  for (int i = 0; i < PerThread; ++i) {
    const int k = threadIdx.x + i * kPix;
    if (k < n) stage_issue(s, k, packed, idx[i]);
  }
}

template <int PerThread>
__device__ __forceinline__ void batch_finish(const Batch& s, int n, float ox,
                                             float oy) {
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < PerThread; ++i) {
    const int k = threadIdx.x + i * kPix;
    if (k < n) stage_finish(s, k, ox, oy);
  }
}

// Row indices of entries [base, base + n) that this thread will stage.
template <int PerThread>
__device__ __forceinline__ void batch_indices(const int32_t* __restrict__ src,
                                              int first, int n,
                                              int32_t (&idx)[PerThread]) {
#pragma unroll
  for (int i = 0; i < PerThread; ++i) {
    const int k = threadIdx.x + i * kPix;
    idx[i] = k < n ? __ldg(src + first + k) : 0;
  }
}

// ---- per-(pixel, entry) arithmetic --------------------------------------

// power = -0.5 (a dx^2 + c dy^2) - b dx dy and alpha = min(0.99, op e^power)
// of an entry (geo = [mx, my, a, b], col = [c, r, op, depth]) at pixel
// (px, py).  Returns false when the entry is skipped (power > 0 or alpha <
// 1/255); otherwise sets dx, dy and alpha.
__device__ __forceinline__ bool entry_alpha(float4 geo, float4 col, float px,
                                            float py, float* dx, float* dy,
                                            float* alpha) {
  const float ddx = __fsub_rn(px, geo.x);
  const float ddy = __fsub_rn(py, geo.y);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(geo.z, ddx), ddx),
                               __fmul_rn(__fmul_rn(col.x, ddy), ddy));
  const float power =
      __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(geo.w, ddx), ddy));
  if (power > 0.0f) return false;
  const float a = fminf(kAlphaMax, __fmul_rn(col.z, expf(power)));
  if (a < kAlphaMin) return false;
  *dx = ddx;
  *dy = ddy;
  *alpha = a;
  return true;
}

// Transmittance after an entry of opacity `alpha`.
__device__ __forceinline__ float next_T(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// ---- a warp's list of a staged batch ----------------------------------
//
// The records of a batch whose box meets the warp's rectangle, in slot
// order, compacted into the warp's own slice of shared memory (32 boxes
// tested a round: `__ballot_sync`, each hit's place by `__popc`).  The
// kernels walk it a group at a time (K1 8 records, K2 6): the group's
// alphas first, independent of one another so that their shared loads
// and expf overlap, then its blends in order.  The list is padded with
// record 0 to a multiple of 8 (the walks ignore places past the count),
// so a group's indices are whole 16- or 4-byte loads.
constexpr int kListPad = 8;

// A warp's list capacity for batches of `size` records.
__host__ __device__ constexpr int list_capacity(int size) {
  return size + kListPad;
}

// Returns the count; warp-uniform.  `list` is 16-byte aligned.
__device__ __forceinline__ int build_list(const Batch& s, int n, int x0,
                                          int y0, int lane, uint16_t* list) {
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int k = j0 + lane;
    const bool hit = k < n && box_meets(s.box[k], x0, y0);
    const uint32_t mask = __ballot_sync(kFull, hit);
    if (hit) list[count + __popc(mask & ((1u << lane) - 1u))] = (uint16_t)k;
    count += __popc(mask);
  }
  if (lane < kListPad) list[count + lane] = 0;
  __syncwarp();
  return count;
}

using kernel_launch::allow_smem;

}  // namespace spf
