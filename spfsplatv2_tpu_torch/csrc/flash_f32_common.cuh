// The building blocks of K5's float32 forward (flash_f32_forward.cu):
// 64-row tiles of (n, 64) float32 matrices in shared memory and the two
// kinds of 64 x 64 x 64 product it takes, each thread holding a 4 x 4
// register micro-tile of the result and running plain FP32 FMAs.
//
// Why not one TF32 pass on the tensor cores: tf32 keeps 10 of float32's
// 23 mantissa bits, and one pass would move a 64-term product by ~1e-3 of
// its size, a divergence from float32 that the port does not take.  Three
// passes do not have that cost: with x = hi + lo (hi = tf32(x), lo =
// tf32(x - hi)), lo*hi + hi*lo + hi*hi drops only lo*lo (~2^-22) and
// keeps float32 accuracy at a third of the TF32 rate (165 TFLOP/s, 2.5x
// the FMA rate).  The backward pair runs that way on wgmma
// (flash_f32_backward_{dkv,dq}.cu, flash_sm90.cuh); this forward is
// still on FMAs (later work).
//
// A CTA is 256 threads, thread t = (ty, tx) = (t / 16, t % 16).  Its
// micro-tile takes rows ty*4 .. ty*4+3 of the result; the columns are
// tx + 16 j (j < 4) for a product whose columns are rows of the second
// operand (S = A B^T), tx*4 .. tx*4+3 for one whose columns run along
// its rows (C = A B).  Every shared read is a float4: the 8 threads of a
// quarter warp share ty, so the first operand's reads are broadcasts,
// and the second operand's are 8 distinct rows (padded to kStride = 68
// floats, which puts 8 consecutive rows' 16-byte pieces in 8 distinct
// bank groups) or 128 contiguous bytes.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace flash_f32 {

constexpr int kD = 64;          // head dim, the only one K5 takes
constexpr int kTile = 64;       // rows of a Q, K, V, dO, P or dS tile
constexpr int kStride = 68;     // floats a tile row takes in shared memory
constexpr int kTileFloats = kTile * kStride;
constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Rows row0 .. row0+63 of a row-major (n, 64) matrix into a padded
// shared tile; rows at or past n read as zeros.
__device__ __forceinline__ void load_tile(float* tile, const float* g,
                                          int row0, int n) {
#pragma unroll
  for (int i = 0; i < kTile * kD / 4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 4, c = (idx & 15) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = ld4(g + (size_t)(row0 + r) * kD + c);
    st4(tile + r * kStride + c, v);
  }
}

// acc[i][j] += sum_d A[ty*4+i][d] * B[tx+16j][d]   (S = A B^T)
__device__ __forceinline__ void product_abt(const float* a, const float* b,
                                            float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* ar = a + ty * 4 * kStride;
  const float* br = b + tx * kStride;
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(ar + i * kStride + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(br + j * 16 * kStride + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

__device__ __forceinline__ void fma_row(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// acc[i][j] += sum_k A[ty*4+i][k] * B[k][tx*4+j]   (C = A B)
__device__ __forceinline__ void product_ab(const float* a, const float* b,
                                           float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* ar = a + ty * 4 * kStride;
  const float* bc = b + tx * 4;
#pragma unroll
  for (int k = 0; k < kTile; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(ar + i * kStride + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) bv[kk] = ld4(bc + (k + kk) * kStride);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fma_row(acc[i], av[i].x, bv[0]);
      fma_row(acc[i], av[i].y, bv[1]);
      fma_row(acc[i], av[i].z, bv[2]);
      fma_row(acc[i], av[i].w, bv[3]);
    }
  }
}

// Rows ty*4 .. ty*4+3 of a 4 x 4 micro-tile with columns tx*4 .. tx*4+3,
// times `scale`, into a row-major (n, 64) matrix; rows at or past n are
// not stored.
__device__ __forceinline__ void store_rows(float* g, int row0, int n,
                                           const float (&acc)[4][4],
                                           float scale) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r < n)
      st4(g + (size_t)r * kD + tx * 4,
          make_float4(acc[i][0] * scale, acc[i][1] * scale, acc[i][2] * scale,
                      acc[i][3] * scale));
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

}  // namespace flash_f32
