// K5, backward, dK and dV, float32: the gradients of exact softmax
// attention over (b, h, n, 64) float32 with respect to K and V.
//
// Replaces jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_dkv_kernel (launched at :1121) for float32 inputs.  As
// there, P is rebuilt from the forward's log-sum-exp and di = rowsum(dO *
// O) comes from outside (ops/attention.py:_FlashAttention.backward):
//   P  = exp(Q K^T * scale - lse)      dP = dO V^T
//   dS = P * (dP - di)                 dV = P^T dO,  dK = scale * dS^T Q
// to float32 accuracy: every product runs on the tensor cores as 3xTF32
// (flash_sm90.cuh: lo*hi + hi*lo + hi*hi, summed in float32), and P and
// dS are split into hi and lo in registers, never rounded further.
//
// One CTA owns 128 key rows of one (batch, head), 64 for each of two
// consumer warpgroups, and walks every query tile of 32:
//   S^T  = K Q^T      A = K (registers), B = the Q tile as it lies
//   dP^T = V dO^T     A = V (shared), B = the dO tile as it lies
//   P^T  = exp2(S^T * scale * log2e - lse * log2e), 0 past n_q
//   dV  += P^T dO     A = P^T (registers), B = the dO^T tile
//   dS^T = P^T (dP^T - di)
//   dK  += dS^T Q     A = dS^T (registers), B = the Q^T tile;
// S^T and dP^T are m64n32k8 products over the head dim, dV and dK
// m64n64k8 over the tile's 32 queries, each in three passes.  tf32 has
// no transpose bit, so the B tiles of dV and dK, whose reduced axis is
// the queries, come transposed (and the queries permuted inside groups
// of 8, so that an accumulator is an A fragment as it lies) from the
// split pre-pass (flash_f32_split.cu), as do the hi and lo planes of Q,
// K, V and dO.  A tile's dV and dK products are summed in registers by
// wgmma, then added to running sums in shared memory (each thread its own
// 64 floats) in float32 rounded to nearest: wgmma rounds its sums toward
// zero, a bias that grows with the ~1500 k8 steps of 4096 queries to the
// order of the 1e-4 bar, against the ~2^-24 a step of a rounded sum a
// tile.  Query rows at
// or past n_q are set to P = dS = 0 by their index; key rows at or past
// n_k are computed and never stored.
//
// What bounds it on an H100: the tensor cores.  The four products are
// 8 * n_q * n_k * 64 FLOPs per head, three times over: at the encoder's
// (3, 16, 4096, 64) 2.50 ms at the TF32 rate of 495 TFLOP/s (on the
// FP32 FMA units, 67 TFLOP/s, the bound would be 6.15 ms).  What
// the design does about it:
//  - Each CTA streams every query tile's eight planes (Q, dO, Q^T, dO^T,
//    hi and lo: 8 MB at 4096 queries), mostly from L2; 128 keys a CTA
//    halve that traffic against 64 keys (25.8 GB a call at the encoder's
//    shape), which ran the same products markedly slower on one
//    warpgroup.
//  - Shared memory sets the layout: V for 128 keys (64 KB), the running
//    sums (64 KB) and a ring of three 32 KB slots, each a half of a
//    query tile (Q and dO as they lie, with lse and di; or Q^T and dO^T),
//    so that the next tile's first half loads while this tile's second
//    is in use; K lives in registers as S^T's A fragments (64 a thread).
//  - A producer warpgroup gives its registers to the consumers
//    (setmaxnreg) and one thread issues the TMA copies; the two consumer
//    warpgroups share every slot, and while one waits on its dK product
//    and sums it, the other can use the tensor cores.
//  - The softmax of a tile runs behind its dP^T product, and dS behind
//    its dV product; one ex2 per element with masked entries sent to
//    2^-inf, so no branch splits the warpgroup and no wgmma sits in a
//    branch.  A tile's dK and dV start from its first product (scale-d
//    off), not from zeros set by other instructions (ptxas C7515), and
//    are read by other instructions only after a wait in the iteration
//    that issued them (ptxas C7514).
//  - Deterministic: each CTA writes its dK and dV rows once, no atomics.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kKeys = 128;                 // key rows per CTA
constexpr int kQTile = 32;                 // query rows per tile
constexpr int kSlots = 3;                  // ring of half-tiles
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr uint32_t kSpan = 128;            // one swizzled row of 32 floats
// V: hi and lo planes of 128 keys x 64, each two column halves; a
// warpgroup's 64 keys start 64 spans into a half.
constexpr uint32_t kVHalf = kKeys * kSpan;
constexpr uint32_t kVPlane = 2 * kVHalf;
// A slot holds the first half of a tile, Q and dO (hi, lo; 32 queries x
// 64, two column halves each), or its second, Q^T and dO^T (hi, lo; 64
// columns x 32 queries); both are four 8 KB planes.
constexpr uint32_t kQHalf = kQTile * kSpan;
constexpr uint32_t kPlane = 2 * kQHalf;  // = kD * kSpan
constexpr uint32_t kSlotBytes = 4 * kPlane;
constexpr uint32_t kAtQ = 0, kAtDO = 2 * kPlane;    // first half
constexpr uint32_t kAtQT = 0, kAtDOT = 2 * kPlane;  // second half
// As in flash_backward_dkv.cu: a tile's lse or di slice comes in as a box
// of kQTile + 4 floats from the 16-byte boundary at or below it.
constexpr int kVecBox = kQTile + 4;
constexpr uint32_t kVecBytes = 256;
constexpr uint32_t kOffV = 0;
constexpr uint32_t kOffRing = kOffV + 2 * kVPlane;
constexpr uint32_t kOffLse = kOffRing + kSlots * kSlotBytes;
constexpr uint32_t kOffDi = kOffLse + kSlots * kVecBytes;
// dK and dV's running sums: each consumer thread's 64 floats, as 16
// float4 at (j * 256 + thread) * 16 B.
constexpr uint32_t kOffSum = kOffDi + kSlots * kVecBytes;
constexpr uint32_t kOffBar = kOffSum + kConsumers * 64 * 4;  // v, full[], empty[]
constexpr uint32_t kSmemBytes =
    kOffBar + 8 * (1 + 2 * kSlots) + kSwizzleBytes;  // + alignment slack
static_assert(kSmemBytes <= 232448, "shared memory");
constexpr uint32_t kFirstTx = kSlotBytes + 2 * kVecBox * 4;
// 384 threads start at 168 registers; the producer warpgroup drops to 40
// so that each consumer can hold 232.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// sum += (dK, dV): a tile's products into the running sums.
__device__ __forceinline__ void add_to_sum(float4* sum, const float (&dk)[32],
                                           const float (&dv)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float* d = j < 8 ? dk + 4 * j : dv + 4 * (j - 8);
    float4 v = sum[j * kConsumers];
    v.x += d[0], v.y += d[1], v.z += d[2], v.w += d[3];
    sum[j * kConsumers] = v;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_f32_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_qt,
                     const __grid_constant__ CUtensorMap map_dot,
                     const __grid_constant__ CUtensorMap map_lse,
                     const __grid_constant__ CUtensorMap map_di,
                     const float* __restrict__ k_hl, float* __restrict__ dk,
                     float* __restrict__ dv, int n_q, int n_k, float scale,
                     float scale_log2) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(kSwizzleBytes - 1);
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t v_bar = base + kOffBar;
  const auto full = [&](int s) { return v_bar + 8 + 8 * s; };
  const auto empty = [&](int s) { return v_bar + 8 + 8 * (kSlots + s); };
  const auto slot = [&](int s) { return base + kOffRing + s * kSlotBytes; };
  const int bh = blockIdx.y, n_bh = gridDim.y;
  const int k0 = blockIdx.x * kKeys;
  const int n_tiles = (n_q + kQTile - 1) / kQTile;

  if (threadIdx.x == 0) {
    mbar_init(v_bar, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer warpgroup gives its registers to the consumers; one
    // thread issues the copies: V once, then the half-tiles in order
    // (tile i's first half is the ring's use 2i, its second 2i + 1).
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(v_bar, 2 * kVPlane);
      for (int p = 0; p < 2; ++p)  // hi, lo
        for (int h = 0; h < 2; ++h)
          tma_load_box(base + kOffV + p * kVPlane + h * kVHalf, &map_v,
                       v_bar, 32 * h, k0, p * n_bh + bh);
      for (int u = 0; u < 2 * n_tiles; ++u) {
        const int s = u % kSlots, q0 = (u >> 1) * kQTile;
        mbar_wait(empty(s), ((u / kSlots) & 1) ^ 1);
        if ((u & 1) == 0) {
          mbar_expect_tx(full(s), kFirstTx);
          for (int p = 0; p < 2; ++p)
            for (int h = 0; h < 2; ++h) {
              const uint32_t at = p * kPlane + h * kQHalf;
              tma_load_box(slot(s) + kAtQ + at, &map_q, full(s), 32 * h, q0,
                           p * n_bh + bh);
              tma_load_box(slot(s) + kAtDO + at, &map_do, full(s), 32 * h,
                           q0, p * n_bh + bh);
            }
          const int at = (bh * n_q + q0) & ~3;
          tma_load_vector(base + kOffLse + s * kVecBytes, &map_lse, full(s),
                          at);
          tma_load_vector(base + kOffDi + s * kVecBytes, &map_di, full(s),
                          at);
        } else {
          mbar_expect_tx(full(s), kSlotBytes);
          for (int p = 0; p < 2; ++p) {
            tma_load_box(slot(s) + kAtQT + p * kPlane, &map_qt, full(s), q0,
                         0, p * n_bh + bh);
            tma_load_box(slot(s) + kAtDOT + p * kPlane, &map_dot, full(s),
                         q0, 0, p * n_bh + bh);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;  // keys k0 + 64 wg ... + 63
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = k0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const int shift = (bh * n_q) & 3;  // i * kQTile is a multiple of 4
    const uint32_t v_hi = base + kOffV + wg * 64 * kSpan;
    float dk_acc[32], dv_acc[32];  // one tile's products
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    float4* sum = reinterpret_cast<float4*>(smem + kOffSum) + threadIdx.x;
#pragma unroll
    for (int j = 0; j < 16; ++j) sum[j * kConsumers] = make_float4(0, 0, 0, 0);

    // K's hi and lo planes as the A fragments of S^T, k = the head dim
    // in its own order (a0 = [g][t], a1 = [g+8][t], a2 = [g][t+4],
    // a3 = [g+8][t+4] of each k8 step); rows past n_k read as zero.
    uint32_t ka_hi[8][4], ka_lo[8][4];
    {
      const size_t plane = (size_t)n_bh * n_k * kD;
      const float* kg = k_hl + (size_t)bh * n_k * kD;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row + 8 * (e & 1), c = 8 * kk + t + 4 * (e >> 1);
          const size_t at = (size_t)r * kD + c;
          ka_hi[kk][e] = r < n_k ? __float_as_uint(kg[at]) : 0u;
          ka_lo[kk][e] = r < n_k ? __float_as_uint(kg[plane + at]) : 0u;
        }
    }

    mbar_wait(v_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int sa = (2 * i) % kSlots, sb = (2 * i + 1) % kSlots;
      const uint32_t a = slot(sa), b = slot(sb);
      const float* lse_s =
          reinterpret_cast<const float*>(smem + kOffLse + sa * kVecBytes) +
          shift;
      const float* di_s =
          reinterpret_cast<const float*>(smem + kOffDi + sa * kVecBytes) +
          shift;
      mbar_wait(full(sa), ((2 * i) / kSlots) & 1);

      float p[16], ds[16];  // 64 keys x 32 queries
      wgmma_fence();
      product3_rs_k64(p, ka_hi, ka_lo, a + kAtQ, a + kAtQ + kPlane,
                      kQHalf);  // S^T
      wgmma_commit();
      product3_ss(ds, v_hi, v_hi + kVPlane, kVHalf, a + kAtDO,
                  a + kAtDO + kPlane, kQHalf);  // dP^T
      wgmma_commit();
      wgmma_wait<1>();  // S^T is done; dP^T may still run
      keep(p);

      // Columns are queries: this thread's are 8j + 2t + (e & 1).
      const int q_col = i * kQTile + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + (e & 1);
          const float x = fmaf(p[4 * j + e], scale_log2,
                               -lse_s[c + 2 * t] * kLog2e);
          p[4 * j + e] = exp2_approx(q_col + c < n_q ? x : -CUDART_INF_F);
        }
      acc_to_a3(p_hi, p_lo, p);
      mbar_wait(full(sb), ((2 * i + 1) / kSlots) & 1);
      wgmma_fence();
      product3_rs(dv_acc, p_hi, p_lo, b + kAtDOT, b + kAtDOT + kPlane, 0);
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is done; dV may still run
      keep(ds);

#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[4 * j + e] =
              p[4 * j + e] * (ds[4 * j + e] - di_s[8 * j + 2 * t + (e & 1)]);
      // The first half (and its lse and di) is no longer read.
      release(empty(sa), lane);
      acc_to_a3(ds_hi, ds_lo, ds);
      wgmma_fence();
      product3_rs(dk_acc, ds_hi, ds_lo, b + kAtQT, b + kAtQT + kPlane, 0);
      wgmma_commit();
      // The tile's products are done: the second half can be refilled,
      // and its dK and dV go into the sums.
      wgmma_wait<0>();
      keep(dk_acc);
      keep(dv_acc);
      keep(p_hi);
      keep(p_lo);
      keep(ds_hi);
      keep(ds_lo);
      release(empty(sb), lane);
      add_to_sum(sum, dk_acc, dv_acc);
    }
    keep(ka_hi);
    keep(ka_lo);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 k4 = sum[j * kConsumers], v4 = sum[(j + 8) * kConsumers];
      dk_acc[4 * j] = k4.x, dk_acc[4 * j + 1] = k4.y;
      dk_acc[4 * j + 2] = k4.z, dk_acc[4 * j + 3] = k4.w;
      dv_acc[4 * j] = v4.x, dv_acc[4 * j + 1] = v4.y;
      dv_acc[4 * j + 2] = v4.z, dv_acc[4 * j + 3] = v4.w;
    }

    const size_t off = (size_t)bh * n_k * kD;
    store_rows_f32(dv + off, dv_acc, row, n_k, 1.0f);
    store_rows_f32(dk + off, dk_acc, row, n_k, scale);
  }
}

}  // namespace

// q_hl, do_hl (2, bh, n_q, 64) and k_hl, v_hl (2, bh, n_k, 64): the hi
// and lo planes of q, dO, k, v; q_t, do_t (2, bh, 64, n8(n_q)): those of
// q and dO transposed and permuted (flash_f32_split.cu); lse and di
// (bh, n_q) (lse in natural units); dk, dv (bh, n_k, 64); all float32,
// contiguous and 16-byte aligned on the current device.  Returns the
// launch's cudaError_t, or kErrTensorMap when a tensor map cannot be
// encoded.
extern "C" int spf_flash_f32_backward_dkv(
    const void* q_hl, const void* k_hl, const void* v_hl, const void* do_hl,
    const void* q_t, const void* do_t, const void* lse, const void* di,
    void* dk, void* dv, int bh, int n_q, int n_k, float scale, void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  // TMA coordinates are 32-bit: the lse/di boxes start at bh * n_q + q0.
  if ((long long)bh * n_q + kVecBox > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int n8 = (n_q + 7) & ~7;
  CUtensorMap map_q, map_v, map_do, map_qt, map_dot, map_lse, map_di;
  if (!f32_map(&map_q, q_hl, kD, n_q, 2 * bh, kQTile) ||
      !f32_map(&map_do, do_hl, kD, n_q, 2 * bh, kQTile) ||
      !f32_map(&map_v, v_hl, kD, n_k, 2 * bh, kKeys) ||
      !f32_map(&map_qt, q_t, n8, kD, 2 * bh, kD) ||
      !f32_map(&map_dot, do_t, n8, kD, 2 * bh, kD) ||
      !vector_map(&map_lse, lse, (long long)bh * n_q, kVecBox) ||
      !vector_map(&map_di, di, (long long)bh * n_q, kVecBox))
    return kErrTensorMap;
  static uint64_t raised = 0;
  const cudaError_t allowed =
      allow_smem(flash_f32_dkv_kernel, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((n_k + kKeys - 1) / kKeys), (unsigned)bh);
  flash_f32_dkv_kernel<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      map_q, map_v, map_do, map_qt, map_dot, map_lse, map_di,
      static_cast<const float*>(k_hl), static_cast<float*>(dk),
      static_cast<float*>(dv), n_q, n_k, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}
