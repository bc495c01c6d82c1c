// Hopper building blocks shared by K5's three bf16 kernels
// (flash_forward.cu, flash_backward_dkv.cu, flash_backward_dq.cu), its
// three float32 kernels (flash_f32_forward.cu,
// flash_f32_backward_{dkv,dq}.cu) and the checks
// of their products (wgmma_check.cu, wgmma_tf32_check.cu): TMA tile loads
// into 128-byte-swizzled shared memory through tensor maps, mbarriers,
// named barriers, wgmma m64n64k16 / m64n128k16 (bf16 in, f32 accumulate)
// with B, and optionally A, read from shared memory, and, at the end of
// the file, wgmma m64n32k8 / m64n64k8 on tf32 in three passes (3xTF32),
// A from shared memory or registers.
//
// Tiles.  Every operand is a (n, 64) bf16 row-major matrix of one
// (batch, head) pair, and a 64-wide bf16 row is 128 B.  TMA copies a box
// of R rows through a 3-D tensor map over (64, n, b*h) with
// CU_TENSOR_MAP_SWIZZLE_128B: row r lands at r * 128 B with its eight
// 16-byte chunks permuted as c ^ (r % 8).  Rows at or past n lie outside
// dim 1 and are filled with zeros, never read from the next head.  Every
// tile starts on a 1024 B boundary (one swizzle period of 8 rows).
//
// wgmma reads such a tile through a 64-bit shared-memory descriptor
// (start >> 4 in bits 0-13, LBO >> 4 in 16-29, SBO >> 4 in 32-45, layout 1
// = 128-byte swizzle in bits 62-63):
//  - K-major: the product's k axis is the row's 64 elements (A = K, Q, dO
//    as they lie; B = a tile whose rows are the product's n).  SBO = 1024 B
//    from one 8-row group to the next; LBO is not used.  The k16 steps
//    advance the start by 32 B inside the 128 B row, and a 64-row slice
//    of a 128-row tile starts 8192 B in.
//  - MN-major: the product's k axis runs down the tile's rows and its n
//    axis (64 wide, one swizzle atom) along them, so B is the staged tile
//    read transposed, with no transposed copy: the instruction's
//    transpose bit is 1, SBO = 1024 B from one group of 8 k-rows to the
//    next, and the k16 steps advance the start by 16 rows = 2048 B.  LBO,
//    the distance between 64-wide n atoms, is not used at n = 64; it is
//    set to 1024 B as well.
//
// Fragments (PTX ISA, "Register fragments and shared memory matrix
// layouts" of wgmma .m64nNk16): warp w of a warpgroup owns rows 16w to
// 16w + 15 of the 64; for lane (g = lane / 4, t = lane % 4)
//   D (f32):  d[4j + e] = row 16w + g + 8 * (e / 2), column 8j + 2t + e % 2;
//   A (bf16, from registers, one k16 step): a0 = [g][2t, 2t+1],
//             a1 = [g+8][2t, 2t+1], a2 = [g][2t+8, 2t+9], a3 = [g+8][2t+8, 2t+9];
// the lower column in the lower 16 bits.  Two neighbouring 8-column
// blocks of D, rounded to bf16, are the A fragment of one k16 step of the
// next product (`to_a`): P and dS feed their products from registers.
//
// Ordering.  wgmma runs asynchronously: `wgmma_fence` comes before a
// product whose registers (accumulator or A) other instructions touched
// since the last product; `keep` after a `wgmma_wait` pins the registers
// in place, so that the compiler neither reads an accumulator before the
// wait nor reuses an A fragment's registers while the product still
// reads them.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                 // head dimension (the only one taken)
constexpr uint32_t kRowBytes = kD * 2;  // one bf16 row, one swizzle span
constexpr uint32_t kSwizzleBytes = 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// Returned by the C entry points when a tensor map cannot be encoded.
constexpr int kErrTensorMap = 10000;

// ---- host: tensor maps through the driver entry point ----------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver library; the kernels'
// libraries are built without -lcuda, so it is reached through the
// runtime's cudaGetDriverEntryPoint.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (bh, n, 64) bf16 tensor as a 3-D map over (64, n, bh), boxes of
// `rows` x 64 with the 128-byte swizzle; out-of-range rows read as zero.
inline bool tile_map(CUtensorMap* map, const void* base, int bh, int n,
                     int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {kRowBytes, (cuuint64_t)n * kRowBytes};
  const cuuint32_t box[3] = {(cuuint32_t)kD, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A float32 vector of `len` elements as a 1-D map, boxes of `box`; the
// part of a box past the end reads as zero.
inline bool vector_map(CUtensorMap* map, const void* base, long long len,
                       int box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)len};
  const cuuint64_t strides[1] = {4};  // rank 1: not read
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t step[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                const_cast<void*>(base), dims, strides, boxes, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

using kernel_launch::allow_smem;

// ---- device: shared memory, mbarriers, TMA ---------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Wait until the barrier's phase of the given parity has completed.  A
// fresh barrier counts its (nonexistent) phase of parity 1 as completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Tell a ring stage's `empty` barrier that this warp is done with it
// (one arrival per warp, after all its lanes).
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// One box of a 3-D map at (x, y, z) into shared memory at dst,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_box(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint32_t bar, int x, int y,
                                             int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// The box of a (64, n, bh) bf16 map at (0, row, head).
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row,
                                              int head) {
  tma_load_box(dst, map, bar, 0, row, head);
}

// One box of a 1-D map at element `at`.
__device__ __forceinline__ void tma_load_vector(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int at) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(at)
      : "memory");
}

// Hand registers from this warpgroup to the others of the CTA, or take
// them (warp specialisation; the counts of all warpgroups must balance).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barriers (ids 1-15; 0 is __syncthreads) over `count` threads:
// `sync` waits until `count` threads have arrived, `arrive` counts this
// warp in without waiting.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- device: wgmma ---------------------------------------------------

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(kSwizzleBytes >> 4) << 32) | (1ull << 62);
}

// K-major tile at `addr`, k16 step kk (32 B each).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int kk) {
  return desc_sw128(addr + 32 * kk, 16);
}

// MN-major tile at `addr`, k16 step kk (16 rows = 2048 B each).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int kk) {
  return desc_sw128(addr + 16 * kRowBytes * kk, kSwizzleBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

template <int K>
__device__ __forceinline__ void keep(uint32_t (&x)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

#define SM90_D32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define SM90_D32_LIST                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64) = A B (+ d if accumulate), A and B from shared memory;
// B is read MN-major when kTransB is 1.
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32_LIST
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : SM90_D32(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

#define SM90_D64(d)                                                         \
  SM90_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define SM90_D64_LIST                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128) = A B (+ d if accumulate), A and B from shared memory: the
// same product with B 128 wide (d[4j + e] as above, j up to 15).
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64_LIST
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : SM90_D64(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

// d (64 x 64) = A B (+ d if accumulate), A (one k16 step) from registers.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SM90_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(kTransB));
}

// 2^x in one instruction (ex2.approx.ftz: relative error near 2^-22,
// subnormal results flushed to 0); 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 16K f32 accumulator, rounded to bf16, as K k16 A fragments.
template <int K>
__device__ __forceinline__ void to_a(uint32_t (&a)[K][4],
                                     const float (&d)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// This thread's rows (row, row + 8) of a 64 x 64 accumulator, row h
// times scale[h], into a (n, 64) bf16 matrix; rows at or past n are not
// written.
__device__ __forceinline__ void store_rows(bf16* out, const float (&d)[32],
                                           int row, int n,
                                           const float (&scale)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (size_t)r * kD + 8 * j + 2 * t) =
          pack_bf16(d[4 * j + 2 * h] * scale[h],
                    d[4 * j + 2 * h + 1] * scale[h]);
  }
}

// The same with one scale for both rows.
__device__ __forceinline__ void store_rows(bf16* out, const float (&d)[32],
                                           int row, int n, float scale) {
  const float both[2] = {scale, scale};
  store_rows(out, d, row, n, both);
}

// ---- float32 on the tensor cores: 3xTF32 -----------------------------
//
// K5's float32 kernels (flash_f32_forward.cu,
// flash_f32_backward_{dkv,dq}.cu) run every product on wgmma m64nNk8 with tf32 operands in three passes:
// each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna, round to nearest, ties away from zero), and a product is
// lo*hi + hi*lo + hi*hi, summed in float32 in that order (the small terms
// first).  One pass keeps 10 of float32's 23 mantissa bits and moves a
// 64-term product by ~1e-3 of its size; three passes drop only lo*lo
// (~2^-22), within float32's own rounding of the sums.
//
// tf32 takes no transpose bit: both operands are K-major.  A float32 row
// of 64 is 256 B, two 128-byte swizzle spans, so a 64-column tile lies as
// two column halves of 32 floats (one TMA box each); the k8 steps advance
// 32 B inside a half, four to a half, then move to the other half.
// f32_map below gives such boxes; the hi and lo planes of a tensor are
// one map whose third axis is plane * bh + head.
//
// Fragments (PTX ISA, wgmma .m64nNk8 with .tf32): for lane (g = lane / 4,
// t = lane % 4) of warp w, the A fragment of one k8 step holds rows
// 16w + g and 16w + g + 8 at columns t and t + 4 (a0 = [g][t],
// a1 = [g+8][t], a2 = [g][t+4], a3 = [g+8][t+4]), while an accumulator
// holds columns 2t and 2t + 1.  So an accumulator's 8-column block j
// becomes one k8 step's A fragment as it lies (`acc_to_a3`: a0 = d[4j],
// a1 = d[4j+2], a2 = d[4j+1], a3 = d[4j+3]) if the product's k axis is
// permuted inside each group of 8: k step position L holds column
// c(L) = 2L for L < 4 and 2(L - 4) + 1 for L >= 4.  The same permutation
// applies to the B tile's k axis; the split pre-passes
// (flash_f32_split.cu) write the transposed B operands that way.

// A float32 tensor (depth, rows, inner) as a 3-D map over (inner, rows,
// depth), boxes of box_rows rows x 32 floats (one 128-byte swizzle span)
// with the 128-byte swizzle; out-of-range elements read as zero.  inner
// must be a multiple of 4 (16-byte row stride).
inline bool f32_map(CUtensorMap* map, const void* base, int inner, int rows,
                    int depth, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 4,
                                 (cuuint64_t)inner * rows * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// hi = tf32(x), lo = tf32(x - hi); x - hi is exact in float32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

#define SM90_D16(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

#define SM90_D16_LIST \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32) = A B (+ d if accumulate), one k8 step, tf32 A and B from
// shared memory (both K-major).
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " SM90_D16_LIST
      ", %16, %17, p, 1, 1;\n}\n"
      : SM90_D16(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) = A B (+ d if accumulate), one k8 step, tf32 A from
// registers and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SM90_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SM90_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 32) = A B (+ d if accumulate), one k8 step, tf32 A from
// registers and B from shared memory (K-major): the m64n32k8 form.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " SM90_D16_LIST
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : SM90_D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x N/2) = A B^T over k = 64 in three passes, A as 8 k8 fragments
// (hi, lo) in registers, B (N/2 = 32 or 64 rows) a K-major tile of 64
// floats a row given by its hi and lo planes, a column half b_half bytes
// after the first.  d starts from the first pass's product.
template <int N>
__device__ __forceinline__ void product3_rs_k64(float (&d)[N],
                                                const uint32_t (&a_hi)[8][4],
                                                const uint32_t (&a_lo)[8][4],
                                                uint32_t b_hi, uint32_t b_lo,
                                                uint32_t b_half) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_tf32_rs(d, pass == 0 ? a_lo[kk] : a_hi[kk],
                    desc_k((pass == 1 ? b_lo : b_hi) + (kk >> 2) * b_half,
                           kk & 3),
                    pass > 0 || kk > 0);
}

// d (64 x 32) = A B^T over k = 64 in three passes.  A (64 rows) and B
// (32 rows) are K-major tiles of 64 floats a row, each given by its hi and
// lo planes; a column half (32 floats) of A's planes lies a_half bytes
// after the first, of B's b_half bytes.
__device__ __forceinline__ void product3_ss(float (&d)[16], uint32_t a_hi,
                                            uint32_t a_lo, uint32_t a_half,
                                            uint32_t b_hi, uint32_t b_lo,
                                            uint32_t b_half) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t a = pass == 0 ? a_lo : a_hi;
    const uint32_t b = pass == 1 ? b_lo : b_hi;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_tf32_ss(d, desc_k(a + (kk >> 2) * a_half, kk & 3),
                    desc_k(b + (kk >> 2) * b_half, kk & 3),
                    pass > 0 || kk > 0);
  }
}

// d (64 x 64) (+)= A B over k = 8K <= 32 in three passes, A as K k8
// fragments (hi, lo) in registers, B a K-major tile of 64 rows of 8K
// floats (one swizzle span) given by its hi and lo planes.  accumulate = 0
// starts d from the first pass's product.
template <int K>
__device__ __forceinline__ void product3_rs(float (&d)[32],
                                            const uint32_t (&a_hi)[K][4],
                                            const uint32_t (&a_lo)[K][4],
                                            uint32_t b_hi, uint32_t b_lo,
                                            int accumulate) {
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      wgmma_tf32_rs(d, pass == 0 ? a_lo[kk] : a_hi[kk],
                    desc_k(pass == 1 ? b_lo : b_hi, kk),
                    accumulate || pass > 0 || kk > 0);
}

// A 64 x 8K f32 accumulator as K k8 A fragments (hi, lo), the k axis
// permuted inside each group of 8 as above.
template <int K>
__device__ __forceinline__ void acc_to_a3(uint32_t (&hi)[K][4],
                                          uint32_t (&lo)[K][4],
                                          const float (&d)[4 * K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    split_tf32(d[4 * j + 0], hi[j][0], lo[j][0]);
    split_tf32(d[4 * j + 2], hi[j][1], lo[j][1]);
    split_tf32(d[4 * j + 1], hi[j][2], lo[j][2]);
    split_tf32(d[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// This thread's rows (row, row + 8) of a 64 x 64 f32 accumulator, times
// scale, into a (n, 64) float32 matrix; rows at or past n are not written.
__device__ __forceinline__ void store_rows_f32(float* out,
                                               const float (&d)[32], int row,
                                               int n, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(out + (size_t)r * kD + 8 * j + 2 * t) =
          make_float2(d[4 * j + 2 * h] * scale, d[4 * j + 2 * h + 1] * scale);
  }
}

}  // namespace sm90
