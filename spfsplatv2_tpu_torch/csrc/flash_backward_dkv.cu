// K5, backward dK and dV: gradients of exact softmax attention over
// (b, h, n, 64) bf16 with respect to the keys and values.
//
// Replaces jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_dkv_kernel (launched at :1121), wired into the custom
// VJP by _flash_attention_bwd (:254-321).  As there, the softmax is not
// stored: P = exp(S * scale - lse) is rebuilt from the forward's saved
// per-row log-sum-exp, and di = rowsum(dO * O) comes from outside the
// kernel (one torch op, as JAX computes it outside its kernels).
//
// The TPU kernel walks the query blocks as a sequential grid axis and
// carries dK/dV in scratch between grid steps.  Here one CTA owns a key
// tile of 128 rows of one (batch, head) and walks every query tile of 64
// inside the block, so dK and dV are written once, with no atomics.  Per
// query tile, with the products on wgmma (bf16 in, f32 accumulate; the
// building blocks in flash_sm90.cuh):
//   S^T  = K Q^T      A = K (shared), B = the Q tile as it lies (K-major)
//   dP^T = V dO^T     A = V (shared), B = the dO tile (K-major)
//   P^T  = exp2(S^T * scale * log2e - lse * log2e), 0 past n_q
//   dV  += P^T dO     A = P^T rounded to bf16 (registers), B = the dO
//                     tile read MN-major through the transpose bit
//   dS^T = P^T (dP^T - di), 0 past n_q
//   dK  += dS^T Q     A = dS^T rounded to bf16, B = the Q tile MN-major;
// dK is scaled by `scale` when stored.
//
// What bounds it on an H100: the tensor cores.  The four products are
// 8 * n_q * n_k * 64 FLOPs per head (0.41 TFLOP at the encoder's
// (3, 16, 4096, 64): 0.42 ms at 989 TFLOP/s) against ~0.2 GB of traffic.
// What the design does about it:
//  - wgmma, the only way to the card's tensor-core rate: two consumer
//    warpgroups of 4 warps, 64 keys each, each product an m64n64k16
//    chain; P^T and dS^T go from the accumulator into the next product's
//    A registers, and no tile is ever copied transposed.
//  - TMA with a ring: a producer warpgroup (one thread issues the copies)
//    streams the Q and dO tiles, with their lse and di slices, through a
//    ring of kStages stages guarded by mbarriers (full: the copy landed;
//    empty: all 8 consumer warps are done with it), so the next tiles'
//    copies overlap this tile's math.  K and V come in once.  The tensor
//    maps are 3-D over (64, n, b*h): a tile at the tail of one head reads
//    zeros past n, never the next head's rows.
//  - Registers: the producer warpgroup gives its registers away
//    (setmaxnreg), so each consumer thread holds 232, enough for the four
//    accumulators and the two A fragments without wgmma serialising for
//    want of registers (ptxas C7512 at 168).
//  - Overlap: a tile's dV and dK products run on behind the next tile's
//    S^T and dP^T, and its stage is released once they are done; the
//    softmax uses one ex2 per element, with masked entries sent to
//    2^-inf, so no branch splits the warpgroup.  dK and dV start from the
//    first tile's products (scale-d off) rather than from zeros, which
//    would make ptxas serialise every wgmma (C7515).
//  - Masks by index: zero-filled Q rows still see lse = 0 (P = 1), so
//    queries at or past n_q are set to P = dS = 0 by their index; key
//    rows at or past n_k are computed and never stored.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kKeys = 128;                // key rows per CTA
constexpr int kQTile = 64;                // query rows per ring stage
constexpr int kStages = 4;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr uint32_t kKVBytes = kKeys * kRowBytes;
constexpr uint32_t kTileBytes = kQTile * kRowBytes;
// One stage's lse or di slice comes in as a box of kQTile + 4 floats
// that starts on the 16-byte boundary at or below the slice (a box must
// start 16-byte aligned, and b * h * n_q rows of 4 B need not be), read
// `shift` floats in; each box gets 384 B, a multiple of TMA's 128 B.
constexpr int kVecBox = kQTile + 4;
constexpr uint32_t kVecBytes = 384;
constexpr uint32_t kOffK = 0;
constexpr uint32_t kOffV = kOffK + kKVBytes;
constexpr uint32_t kOffQ = kOffV + kKVBytes;
constexpr uint32_t kOffDO = kOffQ + kStages * kTileBytes;
constexpr uint32_t kOffLse = kOffDO + kStages * kTileBytes;
constexpr uint32_t kOffDi = kOffLse + kStages * kVecBytes;
constexpr uint32_t kOffBar = kOffDi + kStages * kVecBytes;  // kv, full[], empty[]
constexpr uint32_t kSmemBytes =
    kOffBar + 8 * (1 + 2 * kStages) + kSwizzleBytes;  // + alignment slack
constexpr uint32_t kStageTx = 2 * kTileBytes + 2 * kVecBox * 4;
// 384 threads start at 168 registers (64512 of the SM's 65536); the
// producer warpgroup drops to 40 so that each consumer can hold 232.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ CUtensorMap map_lse,
                 const __grid_constant__ CUtensorMap map_di,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int n_q,
                 int n_k, float scale, float scale_log2) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(kSwizzleBytes - 1);
  const uint8_t* smem = smem_raw + (base - raw);
  const uint32_t kv_bar = base + kOffBar;
  const auto full = [&](int s) { return kv_bar + 8 + 8 * s; };
  const auto empty = [&](int s) { return kv_bar + 8 + 8 * (kStages + s); };
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kKeys;
  const int n_tiles = (n_q + kQTile - 1) / kQTile;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer warpgroup gives its registers to the consumers; one
    // thread issues the copies.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_bar, 2 * kKVBytes);
      tma_load_tile(base + kOffK, &map_k, kv_bar, k0, bh);
      tma_load_tile(base + kOffV, &map_v, kv_bar, k0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kStageTx);
        tma_load_tile(base + kOffQ + s * kTileBytes, &map_q, full(s),
                      i * kQTile, bh);
        tma_load_tile(base + kOffDO + s * kTileBytes, &map_do, full(s),
                      i * kQTile, bh);
        const int at = (bh * n_q + i * kQTile) & ~3;
        tma_load_vector(base + kOffLse + s * kVecBytes, &map_lse, full(s), at);
        tma_load_vector(base + kOffDi + s * kVecBytes, &map_di, full(s), at);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;  // keys k0 + 64 wg ... + 63
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int shift = (bh * n_q) & 3;  // i * kQTile is a multiple of 4
    const uint32_t k_rows = base + kOffK + wg * 64 * kRowBytes;
    const uint32_t v_rows = base + kOffV + wg * 64 * kRowBytes;
    float dk_acc[32], dv_acc[32];  // from the first tile's products
    uint32_t pa[4][4], da[4][4];  // P^T and dS^T as A fragments

    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t q_s = base + kOffQ + s * kTileBytes;
      const uint32_t do_s = base + kOffDO + s * kTileBytes;
      const float* lse_s =
          reinterpret_cast<const float*>(smem + kOffLse + s * kVecBytes) +
          shift;
      const float* di_s =
          reinterpret_cast<const float*>(smem + kOffDi + s * kVecBytes) +
          shift;
      mbar_wait(full(s), (i / kStages) & 1);

      float p[32], ds[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(p, desc_k(k_rows, kk), desc_k(q_s, kk), kk);  // S^T
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(ds, desc_k(v_rows, kk), desc_k(do_s, kk), kk);  // dP^T
      wgmma_commit();
      // The last tile's dV and dK ran on behind this tile's first two
      // products; once they and S^T are done, its stage can be refilled.
      wgmma_wait<1>();
      keep(p);
      if (i > 0) release(empty((i - 1) % kStages), lane);

      // Columns are queries: this thread's are 8j + 2t + (e & 1).
      const int q_col = i * kQTile + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + (e & 1);
          const float x = fmaf(p[4 * j + e], scale_log2,
                               -lse_s[c + 2 * t] * kLog2e);
          p[4 * j + e] = exp2_approx(q_col + c < n_q ? x : -CUDART_INF_F);
        }
      to_a(pa, p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(dv_acc, pa[kk], desc_mn(do_s, kk), i > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is done; dV may still run
      keep(ds);

#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[4 * j + e] =
              p[4 * j + e] * (ds[4 * j + e] - di_s[8 * j + 2 * t + (e & 1)]);
      to_a(da, ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(dk_acc, da[kk], desc_mn(q_s, kk), i > 0 || kk > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    keep(dk_acc);
    keep(dv_acc);
    keep(pa);
    keep(da);

    const size_t off = (size_t)bh * n_k * kD;
    const int row = k0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    store_rows(dv + off, dv_acc, row, n_k, 1.0f);
    store_rows(dk + off, dk_acc, row, n_k, scale);
  }
}

}  // namespace

// q, dout (bh, n_q, 64) and k, v, dk, dv (bh, n_k, 64) bf16; lse and di
// (bh, n_q) f32 (lse in natural units); all contiguous and 16-byte
// aligned on the current device.  Returns the launch's cudaError_t, or
// kErrTensorMap when a tensor map cannot be encoded.
extern "C" int spf_flash_backward_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dk, void* dv, int bh, int n_q,
                                      int n_k, float scale, void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  // TMA coordinates are 32-bit: the lse/di boxes start at bh * n_q + q0.
  if ((long long)bh * n_q + kVecBox > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_do, map_lse, map_di;
  if (!tile_map(&map_q, q, bh, n_q, kQTile) ||
      !tile_map(&map_do, dout, bh, n_q, kQTile) ||
      !tile_map(&map_k, k, bh, n_k, kKeys) ||
      !tile_map(&map_v, v, bh, n_k, kKeys) ||
      !vector_map(&map_lse, lse, (long long)bh * n_q, kVecBox) ||
      !vector_map(&map_di, di, (long long)bh * n_q, kVecBox))
    return kErrTensorMap;
  static uint64_t raised = 0;
  const cudaError_t allowed = allow_smem(flash_dkv_kernel, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((n_k + kKeys - 1) / kKeys), (unsigned)bh);
  flash_dkv_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, map_do, map_lse, map_di, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n_q, n_k, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}
