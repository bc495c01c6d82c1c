// K5, forward, float32: exact softmax attention over (b, h, n, 64) float32,
// writing O and each row's log-sum-exp, to float32 accuracy.
//
// Replaces the forward of JAX's bundled TPU flash attention,
// jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_kernel (launched at :758), for float32 inputs, which
// spfsplatv2_tpu/ops/attention.py:sdpa hands it under
// CrocoBackboneConfig.compute_dtype = "float32" once n_k >= FLASH_MIN_KV.
// Given float32, the TPU kernel's products run in float32 with float32
// accumulation and nothing is rounded.  Here every product runs on the
// tensor cores as 3xTF32 (flash_sm90.cuh: each operand split into hi =
// tf32(x) and lo = tf32(x - hi), lo*hi + hi*lo + hi*hi summed in float32,
// which drops only lo*lo, ~2^-22 of the product), and P is split in
// registers, never rounded further.  Like the bf16 kernel
// (flash_forward.cu) it takes the real lengths and masks the ragged last
// key tile by index (4098 keys are no multiple of any tile).
//
// One CTA owns 128 query rows of one (batch, head), 64 for each of two
// consumer warpgroups, with Q's hi and lo A fragments in registers (split
// there from q), and walks every key tile of 64 (the TPU kernel's
// sequential grid axis):
//   S = Q K^T         A = Q (registers), B = the K tile as it lies
//   online softmax    running row max m and sum l in float32 registers,
//                     log2 units, one ex2 per logit; keys at or past n_k
//                     set to P = 0 by their index
//   O_t = P V         A = P (registers, split), B = the V^T tile;
//   O = alpha O + O_t in registers, one fmaf a value (rounded to nearest);
// O is scaled by 1/l when stored, lse = (m + log2 l) ln 2.  S and O_t are
// m64n64k8 products over 64 (head dim, keys) in three passes, each from a
// fresh accumulator (scale-d off), so that wgmma's sums, which round
// toward zero, run over one tile only.  tf32 has no transpose bit, so the
// V^T tile, whose reduced axis is the keys, comes from the forward split
// pre-pass (flash_f32_split.cu: the hi and lo planes of K, and of V
// transposed with the keys permuted inside groups of 8, so that the S
// accumulator is P's A fragment as it lies).  A zero-filled K row past
// n_k gives S = 0, not a masked logit; query rows at or past n_q are
// computed and never stored.
//
// What bounds it on an H100: the tensor cores.  The two products are
// 4 * n_q * n_k * 64 FLOPs per head, three times over: at the encoder's
// (3, 16, 4096, 64) 1.250 ms at the TF32 rate of 495 TFLOP/s (on the
// FP32 FMA units, 67 TFLOP/s, the bound would be 3.08 ms); the ex2 a
// logit (0.21 ms at ~3.9 T/s) and the pre-pass's 0.30 GB (0.09 ms) are
// below it.  What the design does about it:
//  - A producer warpgroup gives its registers to the consumers
//    (setmaxnreg) and one thread streams each key tile's four planes (K
//    and V^T, hi and lo: 64 KB) by TMA through a ring of three
//    mbarrier-guarded stages (192 KB); Q lives in registers (64 a thread)
//    and takes no shared memory.
//  - The two warpgroups share each stage and run unsynchronised: one
//    warpgroup's softmax and sums run while the other's products hold the
//    tensor cores (their products take about three times as long).
//    Making them take turns on the tensor cores through named barriers,
//    as the bf16 forward does, ran slower on the H100.
//  - No wgmma sits in a branch (ptxas C7519/C7520), every accumulator
//    starts from its first product (C7515), and each is read by other
//    instructions only after a wait in the iteration that issued it
//    (C7514).
// Deterministic: each CTA writes its rows once, in a fixed order of sums.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kQRows = 128;                // query rows per CTA
constexpr int kKTile = 64;                 // keys per ring stage
constexpr int kStages = 3;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr uint32_t kSpan = 128;            // one swizzled row of 32 floats
// A stage: K (hi, lo; 64 keys x 64, two column halves each), then V^T
// (hi, lo; 64 columns x 64 keys, two halves of 32 keys each).
constexpr uint32_t kHalf = kKTile * kSpan;  // = kD * kSpan
constexpr uint32_t kPlane = 2 * kHalf;
constexpr uint32_t kStK = 0;
constexpr uint32_t kStVT = kStK + 2 * kPlane;
constexpr uint32_t kStageBytes = kStVT + 2 * kPlane;
constexpr uint32_t kOffBar = kStages * kStageBytes;  // full[], empty[]
constexpr uint32_t kSmemBytes =
    kOffBar + 8 * 2 * kStages + kSwizzleBytes;  // + alignment slack
static_assert(kSmemBytes <= 232448, "shared memory");
// As in flash_f32_backward_dq.cu: 384 threads start at 168 registers; the
// producer warpgroup drops to 40 so that each consumer can hold 232.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__global__ void __launch_bounds__(kThreads, 1)
flash_f32_forward_kernel(const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_vt,
                         const float* __restrict__ q, float* __restrict__ o,
                         float* __restrict__ lse, int n_q, int n_k,
                         float scale_log2) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(kSwizzleBytes - 1);
  const auto full = [&](int s) { return base + kOffBar + 8 * s; };
  const auto empty = [&](int s) {
    return base + kOffBar + 8 * (kStages + s);
  };
  const int bh = blockIdx.y, n_bh = gridDim.y;
  const int q0 = blockIdx.x * kQRows;
  const int n_tiles = (n_k + kKTile - 1) / kKTile;

  if (threadIdx.x == 0) {
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
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, kv0 = i * kKTile;
        const uint32_t st = base + s * kStageBytes;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kStageBytes);
        for (int p = 0; p < 2; ++p)  // hi, lo
          for (int h = 0; h < 2; ++h) {
            const uint32_t at = p * kPlane + h * kHalf;
            tma_load_box(st + kStK + at, &map_k, full(s), 32 * h, kv0,
                         p * n_bh + bh);
            tma_load_box(st + kStVT + at, &map_vt, full(s), kv0 + 32 * h, 0,
                         p * n_bh + bh);
          }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;  // queries q0 + 64 wg ... + 63
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = q0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);

    // Q as S's A fragments, split into hi and lo here, k = the head dim in
    // its own order (a0 = [g][t], a1 = [g+8][t], a2 = [g][t+4],
    // a3 = [g+8][t+4] of each k8 step); rows past n_q read as zero.
    uint32_t qa_hi[8][4], qa_lo[8][4];
    {
      const float* qg = q + (size_t)bh * n_q * kD;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + 8 * (e & 1), c = 8 * kk + t + 4 * (e >> 1);
          split_tf32(r < n_q ? qg[(size_t)r * kD + c] : 0.0f, qa_hi[kk][e],
                     qa_lo[kk][e]);
        }
    }
    float o_t[32];    // one tile's P V (scale-d off at its start)
    float o_sum[32];  // O, the tiles' products summed rounded to nearest
#pragma unroll
    for (int j = 0; j < 32; ++j) o_sum[j] = 0.0f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
    uint32_t p_hi[8][4], p_lo[8][4];  // P as A fragments, k = 64 keys

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t st = base + s * kStageBytes;
      mbar_wait(full(s), (i / kStages) & 1);

      float acc[32];  // S: 64 queries x 64 keys
      wgmma_fence();
      product3_rs_k64(acc, qa_hi, qa_lo, st + kStK, st + kStK + kPlane,
                      kHalf);  // S
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      keep(qa_hi);
      keep(qa_lo);

      // Columns are keys: this thread's are 8j + 2t + (e & 1), rows
      // row + 8 (e >> 1).  The scale is positive: the max of the raw
      // logits is that of the scaled ones.
      const int k_col = i * kKTile + 2 * t;
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = acc[4 * j + e];
          x = k_col + 8 * j + (e & 1) < n_k ? x : -CUDART_INF_F;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // A row's 64 keys lie in the 4 lanes of one quad.
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // Tile 0 holds key 0 < n_k, so the max is finite from it on; m =
        // -inf before it gives alpha = 0.
        const float m_new = fmaxf(m[h], mx[h] * scale_log2);
        alpha[h] = exp2_approx(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = acc[4 * j + e];
          x = exp2_approx(fmaf(x, scale_log2, -m[e >> 1]));
          sum[e >> 1] += x;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], alpha[h], sum[h]);
      acc_to_a3(p_hi, p_lo, acc);
      wgmma_fence();
      product3_rs_k64(o_t, p_hi, p_lo, st + kStVT, st + kStVT + kPlane,
                      kHalf);  // O_t
      wgmma_commit();
      // The tile's products are done: its stage can be refilled, and O_t
      // goes into O.
      wgmma_wait<0>();
      keep(o_t);
      keep(p_hi);
      keep(p_lo);
      release(empty(s), lane);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        o_sum[j] = fmaf(o_sum[j], alpha[(j >> 1) & 1], o_t[j]);
    }

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.0f / l[h];
      const int r = row + 8 * h;
      if (t == 0 && r < n_q)
        lse[(size_t)bh * n_q + r] = (m[h] + log2f(l[h])) * kLn2;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) o_sum[j] *= inv[(j >> 1) & 1];
    store_rows_f32(o + (size_t)bh * n_q * kD, o_sum, row, n_q, 1.0f);
  }
}

}  // namespace

// q, o (bh, n_q, 64) float32; k_hl (2, bh, n_k, 64) and v_t (2, bh, 64,
// n8(n_k)): the hi and lo planes of k, and of v transposed and permuted,
// from the forward split pre-pass (spf_flash_f32_split_forward); lse
// (bh, n_q) float32; all contiguous and 16-byte aligned on the current
// device.  scale multiplies the logits (natural units) and must be
// positive: the row max is taken over the raw logits, which is the max of
// the scaled ones only then (flash_forward_cuda folds any other scale
// into q).  Returns the launch's cudaError_t, or kErrTensorMap when a
// tensor map cannot be encoded.
extern "C" int spf_flash_f32_forward(const void* q, const void* k_hl,
                                     const void* v_t, void* o, void* lse,
                                     int bh, int n_q, int n_k, float scale,
                                     void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  if (!(scale > 0.0f)) return (int)cudaErrorInvalidValue;
  const int n8 = (n_k + 7) & ~7;
  CUtensorMap map_k, map_vt;
  if (!f32_map(&map_k, k_hl, kD, n_k, 2 * bh, kKTile) ||
      !f32_map(&map_vt, v_t, n8, kD, 2 * bh, kD))
    return kErrTensorMap;
  static uint64_t raised = 0;
  const cudaError_t allowed =
      allow_smem(flash_f32_forward_kernel, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((n_q + kQRows - 1) / kQRows), (unsigned)bh);
  flash_f32_forward_kernel<<<grid, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      map_k, map_vt, static_cast<const float*>(q), static_cast<float*>(o),
      static_cast<float*>(lse), n_q, n_k, scale * kLog2e);
  return (int)cudaGetLastError();
}
