// K5, backward dQ: the gradient of exact softmax attention over
// (b, h, n, 64) bf16 with respect to the queries.
//
// Replaces jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_dq_kernel (launched at :1456), the second half of the
// custom VJP _flash_attention_bwd (:254-321).  P is rebuilt from the
// forward's saved log-sum-exp; di = rowsum(dO * O) comes from outside.
//
// One CTA owns 128 query rows of one (batch, head), with their Q and dO
// in shared memory and their lse and di in registers, and walks every key
// tile of 128 inside the block (the TPU kernel's sequential grid axis), so
// dQ is written once, with no atomics.  Per key tile, on wgmma (bf16 in,
// f32 accumulate; the building blocks in flash_sm90.cuh):
//   S  = Q K^T        A = Q (shared), B = the K tile as it lies (K-major)
//   dP = dO V^T       A = dO (shared), B = the V tile (K-major)
//   P  = exp2(S * scale * log2e - lse * log2e), 0 past n_k
//   dS = P (dP - di)
//   dQ += dS K        A = dS rounded to bf16 (registers), B = the K tile
//                     read MN-major through the transpose bit;
// dQ is scaled by `scale` when stored.
//
// What bounds it on an H100: the tensor cores.  The three products are
// 6 * n_q * n_k * 64 FLOPs per head (0.31 TFLOP at the encoder's
// (3, 16, 4096, 64): 0.31 ms at 989 TFLOP/s).  The design is the dK/dV
// kernel's (flash_backward_dkv.cu): two consumer warpgroups of 64 query
// rows on wgmma, a producer warpgroup that gives its registers to them
// and streams the K and V tiles by TMA through a ring of kStages
// mbarrier-guarded stages over 3-D tensor maps, no transposed copy, a
// tile's dQ product running on behind the next tile's S and dP, one ex2
// per element and no accumulator zeroed by other instructions.  The key
// tile is 128 wide (S and dP are m64n128 products, dQ's k runs over 128
// keys): half the barrier rounds of a 64-wide tile, and each A tile read
// from shared memory feeds twice the work.  A zero-filled K row past n_k
// gives S = 0 and P = exp2(-lse), not 0, so keys at or past n_k are set
// to P = 0 by their index; query rows at or past n_q are computed and
// never stored.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kQRows = 128;               // query rows per CTA
constexpr int kKTile = 128;               // key rows per ring stage
constexpr int kStages = 4;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr uint32_t kQBytes = kQRows * kRowBytes;
constexpr uint32_t kTileBytes = kKTile * kRowBytes;
constexpr uint32_t kOffQ = 0;
constexpr uint32_t kOffDO = kOffQ + kQBytes;
constexpr uint32_t kOffK = kOffDO + kQBytes;
constexpr uint32_t kOffV = kOffK + kStages * kTileBytes;
constexpr uint32_t kOffBar = kOffV + kStages * kTileBytes;  // q, full[], empty[]
constexpr uint32_t kSmemBytes =
    kOffBar + 8 * (1 + 2 * kStages) + kSwizzleBytes;  // + alignment slack
// As in the dK/dV kernel: the producer warpgroup drops from 168 registers
// to 40 so that each consumer thread can hold 232.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do,
                const float* __restrict__ lse, const float* __restrict__ di,
                bf16* __restrict__ dq, int n_q, int n_k, float scale,
                float scale_log2) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(kSwizzleBytes - 1);
  const uint32_t q_bar = base + kOffBar;
  const auto full = [&](int s) { return q_bar + 8 + 8 * s; };
  const auto empty = [&](int s) { return q_bar + 8 + 8 * (kStages + s); };
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kQRows;
  const int n_tiles = (n_k + kKTile - 1) / kKTile;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
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
      mbar_expect_tx(q_bar, 2 * kQBytes);
      tma_load_tile(base + kOffQ, &map_q, q_bar, q0, bh);
      tma_load_tile(base + kOffDO, &map_do, q_bar, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTileBytes);
        tma_load_tile(base + kOffK + s * kTileBytes, &map_k, full(s),
                      i * kKTile, bh);
        tma_load_tile(base + kOffV + s * kTileBytes, &map_v, full(s),
                      i * kKTile, bh);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;  // queries q0 + 64 wg ... + 63
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = q0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    float lse_r[2], di_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const size_t at = (size_t)bh * n_q + r;
      lse_r[h] = r < n_q ? lse[at] * kLog2e : CUDART_INF_F;
      di_r[h] = r < n_q ? di[at] : 0.0f;
    }
    const uint32_t q_rows = base + kOffQ + wg * 64 * kRowBytes;
    const uint32_t do_rows = base + kOffDO + wg * 64 * kRowBytes;
    float dq_acc[32];  // from the first tile's product (scale-d off)
    uint32_t da[8][4];  // dS as A fragments, k = the tile's 128 keys

    mbar_wait(q_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t k_s = base + kOffK + s * kTileBytes;
      const uint32_t v_s = base + kOffV + s * kTileBytes;
      mbar_wait(full(s), (i / kStages) & 1);

      float p[64], ds[64];  // 64 queries x 128 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(p, desc_k(q_rows, kk), desc_k(k_s, kk), kk);  // S
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(ds, desc_k(do_rows, kk), desc_k(v_s, kk), kk);  // dP
      wgmma_commit();
      // The last tile's dQ ran on behind this tile's first two products;
      // once it and S are done, its stage can be refilled.
      wgmma_wait<1>();
      keep(p);
      if (i > 0) release(empty((i - 1) % kStages), lane);

      // Columns are keys: this thread's are 8j + 2t + (e & 1).
      const int k_col = i * kKTile + 2 * t;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fmaf(p[4 * j + e], scale_log2, -lse_r[e >> 1]);
          p[4 * j + e] =
              exp2_approx(k_col + 8 * j + (e & 1) < n_k ? x : -CUDART_INF_F);
        }
      wgmma_wait<0>();
      keep(ds);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[4 * j + e] = p[4 * j + e] * (ds[4 * j + e] - di_r[e >> 1]);
      to_a(da, ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<1>(dq_acc, da[kk], desc_mn(k_s, kk), i > 0 || kk > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    keep(dq_acc);
    keep(da);

    store_rows(dq + (size_t)bh * n_q * kD, dq_acc, row, n_q, scale);
  }
}

}  // namespace

// q, dout, dq (bh, n_q, 64) and k, v (bh, n_k, 64) bf16; lse and di
// (bh, n_q) f32 (lse in natural units); all contiguous and 16-byte
// aligned on the current device.  Returns the launch's cudaError_t, or
// kErrTensorMap when a tensor map cannot be encoded.
extern "C" int spf_flash_backward_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* di,
                                     void* dq, int bh, int n_q, int n_k,
                                     float scale, void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!tile_map(&map_q, q, bh, n_q, kQRows) ||
      !tile_map(&map_do, dout, bh, n_q, kQRows) ||
      !tile_map(&map_k, k, bh, n_k, kKTile) ||
      !tile_map(&map_v, v, bh, n_k, kKTile))
    return kErrTensorMap;
  static uint64_t raised = 0;
  const cudaError_t allowed = allow_smem(flash_dq_kernel, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((n_q + kQRows - 1) / kQRows), (unsigned)bh);
  flash_dq_kernel<<<grid, kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, map_do, static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dq), n_q, n_k, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}
