// Tiles and tensor-core fragments of K5's forward (flash_forward.cu);
// the backward kernels are built from flash_sm90.cuh.
//
// Every operand is a (n, 64) bf16 row-major matrix of one (batch, head)
// pair.  A CTA of 4 warps stages 64-row tiles in shared memory, padded
// to a row of 72 bf16 (144 B = 36 words): the fragment loads below read
// word 36 * g + t for lane (g = lane / 4, t = lane % 4), which falls in 32
// different banks.  A tile can also be staged transposed (`load_tile_t`,
// element [c][r] = row r, column c), which turns the operand that an
// m16n8k16 product needs along its k axis into contiguous pairs.
//
// The products are `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`
// (PTX ISA, "Matrix fragments for mma.m16n8k16"): for lane (g, t),
//   A (16 x 16): a0 = [g][2t, 2t+1], a1 = [g+8][2t, 2t+1],
//                a2 = [g][2t+8, 2t+9], a3 = [g+8][2t+8, 2t+9];
//   B (16 x 8):  b0 = [2t, 2t+1][g],  b1 = [2t+8, 2t+9][g];
//   C (16 x 8):  c0, c1 = [g][2t, 2t+1], c2, c3 = [g+8][2t, 2t+1];
// with the lower column (or k) index in the lower 16 bits of a register.
// Two C fragments that are neighbours along n are, packed to bf16, the A
// fragment of a k16 step: this is how P and dS feed the next product
// from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;               // head dimension (the only one taken)
constexpr int kTile = 64;            // rows of a query or key tile
constexpr int kStride = kD + 8;      // padded shared-memory row, in bf16
constexpr int kWarps = 4;            // 16 rows of the CTA's tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kTileElems = kTile * kStride;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* s, int row, int col) {
  return *reinterpret_cast<const uint32_t*>(s + row * kStride + col);
}

// Rows [row0, row0 + 64) of a (n, 64) matrix into s[r][c]; zeros past n.
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int row0,
                                          int n) {
  for (int i = threadIdx.x; i < kTile * kD / 8; i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * kD + c);
    *reinterpret_cast<uint4*>(s + r * kStride + c) = v;
  }
}

// The same rows transposed: s[c][r]; zeros past n.
__device__ __forceinline__ void load_tile_t(bf16* s, const bf16* g, int row0,
                                            int n) {
  for (int i = threadIdx.x; i < kTile * kD / 8; i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * kD + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[(c + j) * kStride + r] = e[j];
  }
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of s.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int r0, int c0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  a[0] = ld32(s, r0 + g, c0 + 2 * t);
  a[1] = ld32(s, r0 + g + 8, c0 + 2 * t);
  a[2] = ld32(s, r0 + g, c0 + 2 * t + 8);
  a[3] = ld32(s, r0 + g + 8, c0 + 2 * t + 8);
}

// B fragment (k in [k0, k0 + 16), n in [n0, n0 + 8)) of the product's B,
// read from s holding B transposed (s[n][k]).
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  b0 = ld32(s, n0 + g, k0 + 2 * t);
  b1 = ld32(s, n0 + g, k0 + 2 * t + 8);
}

// acc[nt] (16 x 8 column block nt of a 16 x 64 result) += A (16 x 64, four
// k16 fragments) times the 64 x 64 matrix whose transpose s holds.
__device__ __forceinline__ void mma_16x64x64(float (&acc)[8][4],
                                             const uint32_t (&a)[4][4],
                                             const bf16* s) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b0, b1;
      load_b(b0, b1, s, nt * 8, kk * 16);
      mma(acc[nt], a[kk], b0, b1);
    }
  }
}

// The 16 x 64 f32 block x, rounded to bf16, as four k16 A fragments.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = 0.0f;
}

// Rows r and r + 8 of this lane's part of a 16 x 64 block, scaled by
// `scale`, into a (n, 64) bf16 matrix at row0 (rows past n are dropped).
__device__ __forceinline__ void store_rows(bf16* out, const float (&x)[8][4],
                                           int row0, int n,
                                           const float (&scale)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= n) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * kD + nt * 8 + 2 * t) =
          pack_bf16(x[nt][2 * i] * scale[i], x[nt][2 * i + 1] * scale[i]);
  }
}

}  // namespace flash
