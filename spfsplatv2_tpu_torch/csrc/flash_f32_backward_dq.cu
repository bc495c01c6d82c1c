// K5, backward, dQ, float32: the gradient of exact softmax attention over
// (b, h, n, 64) float32 with respect to Q.
//
// Replaces jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_dq_kernel (launched at :1456) for float32 inputs:
//   P  = exp(Q K^T * scale - lse)      dP = dO V^T
//   dS = P * (dP - di)                 dQ = scale * dS K
// to float32 accuracy: every product runs on the tensor cores as 3xTF32
// (flash_sm90.cuh: lo*hi + hi*lo + hi*hi, summed in float32), and dS is
// split into hi and lo in registers, never rounded further.
//
// One CTA owns 128 query rows of one (batch, head) (two consumer
// warpgroups of 64), with the hi and lo planes of their Q and dO resident
// in shared memory, their lse, di and dQ in registers, and walks every
// key tile of 32:
//   S  = Q K^T        A = Q (shared), B = the K tile as it lies
//   dP = dO V^T       A = dO (shared), B = the V tile as it lies
//   P  = exp2(S * scale * log2e - lse * log2e), 0 past n_k
//   dS = P (dP - di)
//   dQ += dS K        A = dS (registers), B = the K^T tile;
// a tile's dQ product is summed in registers by wgmma, then added to a
// running sum in float32 rounded to nearest (wgmma rounds its sums toward
// zero; see flash_f32_backward_dkv.cu).
// S and dP are m64n32k8 products over the head dim, dQ m64n64k8 over the
// tile's 32 keys, each in three passes.  tf32 has no transpose bit, so
// dQ's B tile, whose reduced axis is the keys, comes transposed (and the
// keys permuted inside groups of 8, so that the dS accumulator is an A
// fragment as it lies) from the split pre-pass (flash_f32_split.cu), as
// do the hi and lo planes of Q, K, V and dO.  A zero-filled K row past
// n_k gives S = 0 and P = exp2(-lse), not 0, so keys at or past n_k are
// set to P = 0 by their index; query rows at or past n_q get lse = +inf
// (P = 0) and are never stored.
//
// What bounds it on an H100: the tensor cores.  The three products are
// 6 * n_q * n_k * 64 FLOPs per head, three times over: at the encoder's
// (3, 16, 4096, 64) 1.875 ms at the TF32 rate of 495 TFLOP/s (on the
// FP32 FMA units, 67 TFLOP/s, the bound would be 4.62 ms).  The
// design is the dK/dV kernel's (flash_f32_backward_dkv.cu): a producer
// warpgroup (which gives its registers to the consumers) streams each key
// tile's six planes (K, V, K^T, hi and lo) by TMA through a ring of
// kStages mbarrier-guarded stages, the softmax runs behind the dP
// product, one ex2 per element, no wgmma in a branch, no wgmma
// accumulator zeroed by other instructions.  While one warpgroup waits
// on its dQ product and sums it, the other can use the tensor cores.
// The two
// warpgroups share each stage, so each B tile read from shared memory
// feeds twice the work: Q and dO resident take 128 KB, a stage of 32 keys
// 48 KB, two stages 224 KB of the 227 KB.  Deterministic: each CTA
// writes its dQ rows once, no atomics.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kQRows = 128;                // query rows per CTA
constexpr int kKTile = 32;                 // key rows per ring stage
constexpr int kStages = 2;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr uint32_t kSpan = 128;            // one swizzled row of 32 floats
// Q and dO: hi and lo planes of 128 rows x 64, each two column halves; a
// warpgroup's 64 rows start 64 spans into a half.
constexpr uint32_t kQHalf = kQRows * kSpan;
constexpr uint32_t kQPlane = 2 * kQHalf;
// A stage: K and V (hi, lo; 32 keys x 64, two halves each), then K^T
// (hi, lo; 64 columns x 32 keys).
constexpr uint32_t kKHalf = kKTile * kSpan;
constexpr uint32_t kKPlane = 2 * kKHalf;
constexpr uint32_t kTPlane = kD * kSpan;
constexpr uint32_t kStK = 0;
constexpr uint32_t kStV = kStK + 2 * kKPlane;
constexpr uint32_t kStKT = kStV + 2 * kKPlane;
constexpr uint32_t kStageBytes = kStKT + 2 * kTPlane;
constexpr uint32_t kOffQ = 0;
constexpr uint32_t kOffDO = kOffQ + 2 * kQPlane;
constexpr uint32_t kOffStage = kOffDO + 2 * kQPlane;
constexpr uint32_t kOffBar = kOffStage + kStages * kStageBytes;  // q, full[], empty[]
constexpr uint32_t kSmemBytes =
    kOffBar + 8 * (1 + 2 * kStages) + kSwizzleBytes;  // + alignment slack
static_assert(kSmemBytes <= 232448, "shared memory");
// As in flash_backward_dq.cu: 384 threads start at 168 registers; the
// producer warpgroup drops to 40 so that each consumer can hold 232.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__global__ void __launch_bounds__(kThreads, 1)
flash_f32_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_kt,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int n_q, int n_k, float scale, float scale_log2) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(kSwizzleBytes - 1);
  const uint32_t q_bar = base + kOffBar;
  const auto full = [&](int s) { return q_bar + 8 + 8 * s; };
  const auto empty = [&](int s) { return q_bar + 8 + 8 * (kStages + s); };
  const int bh = blockIdx.y, n_bh = gridDim.y;
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
      mbar_expect_tx(q_bar, 4 * kQPlane);
      for (int p = 0; p < 2; ++p)  // hi, lo
        for (int h = 0; h < 2; ++h) {
          const uint32_t at = p * kQPlane + h * kQHalf;
          tma_load_box(base + kOffQ + at, &map_q, q_bar, 32 * h, q0,
                       p * n_bh + bh);
          tma_load_box(base + kOffDO + at, &map_do, q_bar, 32 * h, q0,
                       p * n_bh + bh);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, kv0 = i * kKTile;
        const uint32_t st = base + kOffStage + s * kStageBytes;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kStageBytes);
        for (int p = 0; p < 2; ++p) {
          for (int h = 0; h < 2; ++h) {
            const uint32_t at = p * kKPlane + h * kKHalf;
            tma_load_box(st + kStK + at, &map_k, full(s), 32 * h, kv0,
                         p * n_bh + bh);
            tma_load_box(st + kStV + at, &map_v, full(s), 32 * h, kv0,
                         p * n_bh + bh);
          }
          tma_load_box(st + kStKT + p * kTPlane, &map_kt, full(s), kv0, 0,
                       p * n_bh + bh);
        }
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
    const uint32_t q_hi = base + kOffQ + wg * 64 * kSpan;
    const uint32_t do_hi = base + kOffDO + wg * 64 * kSpan;
    float dq_acc[32];  // one tile's product (scale-d off at its start)
    float dq_sum[32];  // the tiles' products, summed rounded to nearest
#pragma unroll
    for (int j = 0; j < 32; ++j) dq_sum[j] = 0.0f;
    uint32_t ds_hi[4][4], ds_lo[4][4];  // dS as A fragments, k = 32 keys

    mbar_wait(q_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t st = base + kOffStage + s * kStageBytes;
      mbar_wait(full(s), (i / kStages) & 1);

      float p[16], ds[16];  // 64 queries x 32 keys
      wgmma_fence();
      product3_ss(p, q_hi, q_hi + kQPlane, kQHalf, st + kStK,
                  st + kStK + kKPlane, kKHalf);  // S
      wgmma_commit();
      product3_ss(ds, do_hi, do_hi + kQPlane, kQHalf, st + kStV,
                  st + kStV + kKPlane, kKHalf);  // dP
      wgmma_commit();
      wgmma_wait<1>();  // S is done; dP may still run
      keep(p);

      // Columns are keys: this thread's are 8j + 2t + (e & 1).
      const int k_col = i * kKTile + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fmaf(p[4 * j + e], scale_log2, -lse_r[e >> 1]);
          p[4 * j + e] =
              exp2_approx(k_col + 8 * j + (e & 1) < n_k ? x : -CUDART_INF_F);
        }
      wgmma_wait<0>();
      keep(ds);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[4 * j + e] = p[4 * j + e] * (ds[4 * j + e] - di_r[e >> 1]);
      acc_to_a3(ds_hi, ds_lo, ds);
      wgmma_fence();
      product3_rs(dq_acc, ds_hi, ds_lo, st + kStKT, st + kStKT + kTPlane, 0);
      wgmma_commit();
      // The tile's products are done: its stage can be refilled, and its
      // dQ goes into the sum (read in the iteration that issued it, as in
      // flash_f32_backward_dkv.cu).
      wgmma_wait<0>();
      keep(dq_acc);
      keep(ds_hi);
      keep(ds_lo);
      release(empty(s), lane);
#pragma unroll
      for (int j = 0; j < 32; ++j) dq_sum[j] += dq_acc[j];
    }

    store_rows_f32(dq + (size_t)bh * n_q * kD, dq_sum, row, n_q, scale);
  }
}

}  // namespace

// q_hl, do_hl (2, bh, n_q, 64) and k_hl, v_hl (2, bh, n_k, 64): the hi
// and lo planes of q, dO, k, v; k_t (2, bh, 64, n8(n_k)): those of k
// transposed and permuted (flash_f32_split.cu); lse and di (bh, n_q) (lse
// in natural units); dq (bh, n_q, 64); all float32, contiguous and
// 16-byte aligned on the current device.  Returns the launch's
// cudaError_t, or kErrTensorMap when a tensor map cannot be encoded.
extern "C" int spf_flash_f32_backward_dq(const void* q_hl, const void* k_hl,
                                         const void* v_hl, const void* do_hl,
                                         const void* k_t, const void* lse,
                                         const void* di, void* dq, int bh,
                                         int n_q, int n_k, float scale,
                                         void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  const int n8 = (n_k + 7) & ~7;
  CUtensorMap map_q, map_k, map_v, map_do, map_kt;
  if (!f32_map(&map_q, q_hl, kD, n_q, 2 * bh, kQRows) ||
      !f32_map(&map_do, do_hl, kD, n_q, 2 * bh, kQRows) ||
      !f32_map(&map_k, k_hl, kD, n_k, 2 * bh, kKTile) ||
      !f32_map(&map_v, v_hl, kD, n_k, 2 * bh, kKTile) ||
      !f32_map(&map_kt, k_t, n8, kD, 2 * bh, kD))
    return kErrTensorMap;
  static uint64_t raised = 0;
  const cudaError_t allowed =
      allow_smem(flash_f32_dq_kernel, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((n_q + kQRows - 1) / kQRows), (unsigned)bh);
  flash_f32_dq_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, map_do, map_kt, static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<float*>(dq), n_q, n_k,
      scale, scale * kLog2e);
  return (int)cudaGetLastError();
}
