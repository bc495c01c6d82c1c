// Each kind of product that K5's backward kernels build from, alone:
// C (128 x n, f32) = A (128 x 64) B (64 x n), bf16 in, through the
// building blocks of flash_sm90.cuh.  A and B come in by TMA over 3-D
// tensor maps with the 128-byte swizzle, as the kernels' tiles do; two
// warpgroups take 64 rows of A each (the second at the tile's 8192 B
// offset).  A is read from shared memory (K-major), or loaded from device
// memory straight into wgmma's A fragments in registers; B is read
// K-major (b holds B transposed, (n, k) row-major: the kernels' S^T, dP^T,
// S and dP) or MN-major through the transpose bit (b holds B, (k, n)
// row-major: the kernels' dV += P^T dO, dK += dS^T Q, dQ += dS K).  n is
// 64, or 128 for the dQ kernel's m64n128 S and dP (A from shared memory,
// B K-major).
//
// Not on any path of the model: the tests hold each product against
// torch.matmul in float32 on the card, so that a wrong descriptor stride,
// k16 step or transpose bit shows on its own.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr uint32_t kABytes = 128 * kRowBytes;
constexpr uint32_t kBBytes = 128 * kRowBytes;  // room for n = 128
constexpr uint32_t kOffBar = kABytes + kBBytes;
constexpr uint32_t kSmemBytes = kOffBar + 8 + kSwizzleBytes;

template <int kARegs, int kTransB, int kN>
__global__ void __launch_bounds__(256, 1)
wgmma_check_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const bf16* __restrict__ a, float* __restrict__ c) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(kSwizzleBytes - 1);
  const uint32_t bar = base + kOffBar;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, kABytes + (kTransB ? 64 : kN) * kRowBytes);
    tma_load_tile(base, &map_a, bar, 0, 0);
    tma_load_tile(base + kABytes, &map_b, bar, 0, 0);
  }
  mbar_wait(bar, 0);

  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + g;
  const uint32_t b_tile = base + kABytes;
  float d[kN / 2];
  if constexpr (kARegs) {
    uint32_t af[4][4];
    const auto at = [&](int r, int col) {
      return *reinterpret_cast<const uint32_t*>(a + r * kD + col);
    };
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      af[kk][0] = at(row, 16 * kk + 2 * t);
      af[kk][1] = at(row + 8, 16 * kk + 2 * t);
      af[kk][2] = at(row, 16 * kk + 2 * t + 8);
      af[kk][3] = at(row + 8, 16 * kk + 2 * t + 8);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<kTransB>(d, af[kk],
                        kTransB ? desc_mn(b_tile, kk) : desc_k(b_tile, kk),
                        kk);
    wgmma_commit();
    wgmma_wait<0>();
    keep(af);
  } else {
    const uint32_t a_rows = base + wg * 64 * kRowBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<kTransB>(d, desc_k(a_rows, kk),
                        kTransB ? desc_mn(b_tile, kk) : desc_k(b_tile, kk),
                        kk);
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

template <int kARegs, int kTransB, int kN>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
           const bf16* a, float* c, cudaStream_t stream) {
  static uint64_t raised = 0;
  const cudaError_t allowed =
      allow_smem(wgmma_check_kernel<kARegs, kTransB, kN>, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  wgmma_check_kernel<kARegs, kTransB, kN>
      <<<1, 256, kSmemBytes, stream>>>(map_a, map_b, a, c);
  return (int)cudaGetLastError();
}

}  // namespace

// a (128, 64) bf16, b bf16 and c (128, n) f32, contiguous and 16-byte
// aligned on the current device.  a_regs: A from registers; b_mn_major: b
// holds B (64, n) and is read MN-major, else b holds B^T (n, 64).  n is 64,
// or 128 with A from shared memory and B K-major.
extern "C" int spf_wgmma_check(const void* a, const void* b, void* c, int n,
                               int a_regs, int b_mn_major, void* stream) {
  if (n != 64 && (n != 128 || a_regs || b_mn_major))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  const int b_rows = b_mn_major ? 64 : n;
  if (!tile_map(&map_a, a, 1, 128, 128) ||
      !tile_map(&map_b, b, 1, b_rows, b_rows))
    return kErrTensorMap;
  const bf16* a_ = static_cast<const bf16*>(a);
  float* c_ = static_cast<float*>(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 128) return launch<0, 0, 128>(map_a, map_b, a_, c_, s);
  if (a_regs)
    return b_mn_major ? launch<1, 1, 64>(map_a, map_b, a_, c_, s)
                      : launch<1, 0, 64>(map_a, map_b, a_, c_, s);
  return b_mn_major ? launch<0, 1, 64>(map_a, map_b, a_, c_, s)
                    : launch<0, 0, 64>(map_a, map_b, a_, c_, s);
}
