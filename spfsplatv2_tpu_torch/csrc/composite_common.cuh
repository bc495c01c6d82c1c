// Per-(pixel, entry) arithmetic shared by K1 (composite_forward.cu) and K2
// (composite_backward.cu).
//
// K2 re-walks K1's entries and must take exactly K1's decisions: which
// entries are skipped (power > 0, alpha < 1/255) and where each pixel
// stops (T * (1 - alpha) < 1e-4).  Both kernels therefore stage entries
// with `stage_entry` and evaluate them with `entry_alpha` / `next_T`,
// written with explicit round-to-nearest intrinsics (__fmul_rn, __fadd_rn,
// __fsub_rn), which nvcc never contracts into FMAs: the same inputs give
// the same bits in both kernels whatever code surrounds the call.  Both
// files are built with the same flags (no --use_fast_math; expf, not
// __expf).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spf {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kFields = 10;  // [mx, my, conic a, b, c, r, g, b, opacity, depth]
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

// Entries of one tile, staged in shared memory as structure of arrays;
// the mean is tile-local (mean minus tile origin).
template <int N>
struct Staged {
  float mx[N], my[N], ca[N], cb[N], cc[N], r[N], g[N], b[N], op[N], z[N];
};

template <int N>
__device__ __forceinline__ void stage_entry(Staged<N>& s, int k,
                                            const float* __restrict__ packed,
                                            int32_t row_index, float ox,
                                            float oy) {
  const float* row = packed + (int64_t)row_index * kFields;
  s.mx[k] = __fsub_rn(row[0], ox);
  s.my[k] = __fsub_rn(row[1], oy);
  s.ca[k] = row[2];
  s.cb[k] = row[3];
  s.cc[k] = row[4];
  s.r[k] = row[5];
  s.g[k] = row[6];
  s.b[k] = row[7];
  s.op[k] = row[8];
  s.z[k] = row[9];
}

// power = -0.5 (a dx^2 + c dy^2) - b dx dy and alpha = min(0.99, op e^power)
// of entry k at pixel (px, py).  Returns false when the entry is skipped
// (power > 0 or alpha < 1/255); otherwise sets dx, dy and alpha.
template <int N>
__device__ __forceinline__ bool entry_alpha(const Staged<N>& s, int k,
                                            float px, float py, float* dx,
                                            float* dy, float* alpha) {
  const float ddx = __fsub_rn(px, s.mx[k]);
  const float ddy = __fsub_rn(py, s.my[k]);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s.ca[k], ddx), ddx),
                               __fmul_rn(__fmul_rn(s.cc[k], ddy), ddy));
  const float power =
      __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(s.cb[k], ddx), ddy));
  if (power > 0.0f) return false;
  const float a = fminf(kAlphaMax, __fmul_rn(s.op[k], expf(power)));
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

}  // namespace spf
