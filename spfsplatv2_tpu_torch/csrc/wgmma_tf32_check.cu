// Each kind of 3xTF32 product that K5's float32 backward kernels
// (flash_f32_backward_{dkv,dq}.cu) build from, alone, through the
// building blocks of flash_sm90.cuh, on one warpgroup (64 rows):
//  - A from shared memory: C (64 x 32) = A B^T over k = 64, A (64 x 64)
//    and B (32 x 64) given as hi and lo planes (2, rows, 64) and read
//    K-major through two 128-byte-swizzled column halves each (the
//    kernels' dP^T, S and dP);
//  - A from registers, loaded from those planes in device memory as k8
//    fragments in the head dim's own order: the same C = A B^T (the
//    dK/dV kernel's S^T, whose K lives in registers);
//  - A from an accumulator: C (64 x 64) = A X over k = 32, A (64 x 32)
//    given in float32, held by each thread in the accumulator layout of an
//    m64n32 product and turned into k8 A fragments by acc_to_a3 (split,
//    k permuted inside groups of 8), X (32 x 64) given as the split
//    pre-pass writes a transposed operand, hi and lo planes (2, 64, 32)
//    of X^T with X's rows permuted (the kernels' dV, dK and dQ).
// Each in three passes (lo*hi + hi*lo + hi*hi) or, to show why three are
// needed, in one (hi*hi).
//
// Not on any path of the model: the tests hold each product against a
// float64 matmul on the card, so that a wrong descriptor, half offset,
// fragment order or permutation shows on its own.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr uint32_t kSpan = 128;
constexpr uint32_t kAPlane = 64 * 64 * 4;  // A: 64 rows x 64, two halves
constexpr uint32_t kAHalf = 64 * kSpan;
constexpr uint32_t kBPlane = 64 * 64 * 4;  // room for 64 rows x 64
constexpr uint32_t kOffB = 2 * kAPlane;
constexpr uint32_t kOffBar = kOffB + 2 * kBPlane;
constexpr uint32_t kSmemBytes = kOffBar + 8 + kSwizzleBytes;

// kMode: 0 A from shared memory, 1 A from an accumulator, 2 A from
// registers loaded from the planes.
template <int kMode, int kPasses>
__global__ void __launch_bounds__(128, 1)
wgmma_tf32_check_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const float* __restrict__ a, float* __restrict__ c) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(kSwizzleBytes - 1);
  const uint32_t bar = base + kOffBar;
  // B: 32 rows x 64 (two halves of 32 x 32), or 64 rows x 32 (one span)
  // with A from an accumulator.
  constexpr bool kFromAcc = kMode == 1;
  constexpr uint32_t kBHalf = 32 * kSpan;
  constexpr uint32_t kBPlaneUsed = kFromAcc ? 64 * kSpan : 2 * kBHalf;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, (kMode == 0 ? 2 * kAPlane : 0) + 2 * kBPlaneUsed);
    for (int p = 0; p < 2; ++p) {
      if (kMode == 0)
        for (int h = 0; h < 2; ++h)
          tma_load_box(base + p * kAPlane + h * kAHalf, &map_a, bar, 32 * h,
                       0, p);
      if (kFromAcc) {
        tma_load_box(base + kOffB + p * kBPlane, &map_b, bar, 0, 0, p);
      } else {
        for (int h = 0; h < 2; ++h)
          tma_load_box(base + kOffB + p * kBPlane + h * kBHalf, &map_b, bar,
                       32 * h, 0, p);
      }
    }
  }
  mbar_wait(bar, 0);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + g;
  const uint32_t b_hi = base + kOffB, b_lo = b_hi + kBPlane;
  constexpr int kN = kFromAcc ? 64 : 32;
  float d[kN / 2];
  if constexpr (kMode == 1) {
    float acc[16];  // A (64 x 32) in an m64n32 accumulator's layout
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[4 * j + e] = a[(row + 8 * (e >> 1)) * 32 + 8 * j + 2 * t + (e & 1)];
    uint32_t hi[4][4], lo[4][4];
    acc_to_a3(hi, lo, acc);
    wgmma_fence();
    if constexpr (kPasses == 3) {
      product3_rs(d, hi, lo, b_hi, b_lo, 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tf32_rs(d, hi[kk], desc_k(b_hi, kk), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep(hi);
    keep(lo);
  } else if constexpr (kMode == 2) {
    uint32_t hi[8][4], lo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (row + 8 * (e & 1)) * 64 + 8 * kk + t + 4 * (e >> 1);
        hi[kk][e] = __float_as_uint(a[at]);
        lo[kk][e] = __float_as_uint(a[64 * 64 + at]);
      }
    wgmma_fence();
    if constexpr (kPasses == 3) {
      product3_rs_k64(d, hi, lo, b_hi, b_lo, kBHalf);
    } else {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_tf32_rs(d, hi[kk], desc_k(b_hi + (kk >> 2) * kBHalf, kk & 3),
                      kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep(hi);
    keep(lo);
  } else {
    const uint32_t a_hi = base, a_lo = base + kAPlane;
    wgmma_fence();
    if constexpr (kPasses == 3) {
      product3_ss(d, a_hi, a_lo, kAHalf, b_hi, b_lo, kBHalf);
    } else {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_tf32_ss(d, desc_k(a_hi + (kk >> 2) * kAHalf, kk & 3),
                      desc_k(b_hi + (kk >> 2) * kBHalf, kk & 3), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  keep(d);
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(row + 8 * (e >> 1)) * kN + 8 * j + 2 * t + (e & 1)] = d[4 * j + e];
}

template <int kMode, int kPasses>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
           const float* a, float* c, cudaStream_t stream) {
  static uint64_t raised = 0;
  const cudaError_t allowed = allow_smem(
      wgmma_tf32_check_kernel<kMode, kPasses>, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  wgmma_tf32_check_kernel<kMode, kPasses>
      <<<1, 128, kSmemBytes, stream>>>(map_a, map_b, a, c);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0 (A from shared memory) or 2 (A from registers): a (2, 64, 64)
// hi and lo planes of A, b (2, 32, 64) those of B, c (64, 32) = A B^T.
// mode 1 (A from an accumulator): a (64, 32) A in float32, b (2, 64, 32)
// the split pre-pass's transposed planes of X (32 x 64), c (64, 64) =
// A X.  passes: 3 or 1.  All float32, contiguous and 16-byte aligned on
// the current device.
extern "C" int spf_wgmma_tf32_check(const void* a, const void* b, void* c,
                                    int mode, int passes, void* stream) {
  if ((passes != 1 && passes != 3) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  // Only mode 0 reads map_a; it is encoded over a all the same.
  const bool ok =
      mode == 1 ? f32_map(&map_a, a, 32, 64, 1, 64) &&
                      f32_map(&map_b, b, 32, 64, 2, 64)
                : f32_map(&map_a, a, 64, 64, 2, 64) &&
                      f32_map(&map_b, b, 64, 32, 2, 32);
  if (!ok) return kErrTensorMap;
  const float* a_ = static_cast<const float*>(a);
  float* c_ = static_cast<float*>(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    return passes == 3 ? launch<1, 3>(map_a, map_b, a_, c_, s)
                       : launch<1, 1>(map_a, map_b, a_, c_, s);
  if (mode == 2)
    return passes == 3 ? launch<2, 3>(map_a, map_b, a_, c_, s)
                       : launch<2, 1>(map_a, map_b, a_, c_, s);
  return passes == 3 ? launch<0, 3>(map_a, map_b, a_, c_, s)
                     : launch<0, 1>(map_a, map_b, a_, c_, s);
}
