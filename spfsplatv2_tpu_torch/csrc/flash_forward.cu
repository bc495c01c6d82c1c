// K5, forward: exact softmax attention over (b, h, n, 64) bf16 with
// float32 logits and accumulation, writing O and each row's log-sum-exp.
//
// Replaces the forward of JAX's bundled TPU flash attention,
// jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_kernel (launched at :758), which spfsplatv2_tpu/ops/
// attention.py:sdpa reaches once n_k >= FLASH_MIN_KV.  The TPU kernel
// pads both sequences to its 512-row blocks and fences the padding with
// segment ids; this kernel takes the real lengths and masks the ragged
// last key tile itself (4098 keys are no multiple of any tile), so a
// real query sees exactly the n_k real keys.
//
// One CTA owns 192 query rows of one (batch, head), with Q in shared
// memory, and walks every key tile of 128 (the TPU kernel's sequential
// grid axis).  Per key tile, on wgmma (bf16 in, f32 accumulate; the
// building blocks in flash_sm90.cuh):
//   S  = Q K^T        A = Q (shared), B = the K tile as it lies (K-major)
//   online softmax    running row max m and sum l in f32 registers, log2
//                     units, one ex2 per logit; keys at or past n_k -> -inf
//   O  = alpha O + P V  A = P rounded to bf16 (registers), B = the V tile
//                     read MN-major through the transpose bit;
// O is scaled by 1/l when stored, lse = (m * scale * log2e + log2 l) ln 2.
// The sum l takes the f32 p, the product the bf16 P, as the plain version
// does.
//
// What bounds it on an H100: the tensor cores and the exponent unit about
// equally.  The two products are 4 * n_q * n_k * 64 FLOPs per head (0.21
// TFLOP at the encoder's (3, 16, 4096, 64): 0.21 ms at 989 TFLOP/s), and
// every logit takes one ex2 on the SM's 16-lane special-function unit
// (805 M at that shape: ~0.21 ms at ~3.9 T/s).  Run one after the other
// they add up; the design overlaps them:
//  - the dK/dV and dQ kernels' layout, with three consumer warpgroups of
//    64 query rows on wgmma and a producer warpgroup that gives its
//    registers to them (setmaxnreg) and streams the K and V tiles by TMA
//    over 3-D tensor maps through a ring of kStages mbarrier-guarded
//    stages; Q, the stationary operand, stays in shared memory (held as
//    register A fragments, ptxas reused their registers in the backward
//    kernels);
//  - the warpgroups take turns on the tensor cores (named barriers):
//    while one warpgroup's products run, the other two run their softmax,
//    which at head dim 64 takes about as long as the products (with two
//    warpgroups the tensor cores wait for it);
//  - within a warpgroup: tile i's S product is issued together with tile
//    i-1's PV product, and tile i's softmax runs while that PV product
//    holds the tensor cores; O is rescaled once it is done, and only when
//    a row's max rose by more than a factor 2^8 (below);
//  - O starts from a product with scale-d off, never from registers
//    zeroed by other instructions, which makes ptxas serialise every
//    wgmma (C7515); the key mask is applied only on the ragged last tile,
//    by index (a zero-filled K row gives S = 0, not a masked logit).
// Query rows at or past n_q are computed and never stored.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

// Consumer warpgroups of 64 query rows each (see above for why three).
constexpr int kConsumerWGs = 3;
constexpr int kQRows = 64 * kConsumerWGs;    // query rows per CTA
constexpr int kKTile = 128;                  // key rows per ring stage
constexpr int kStages = 4;
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 128;   // and a producer warpgroup
constexpr uint32_t kQBytes = kQRows * kRowBytes;
constexpr uint32_t kTileBytes = kKTile * kRowBytes;
constexpr uint32_t kOffQ = 0;
constexpr uint32_t kOffK = kOffQ + kQBytes;
constexpr uint32_t kOffV = kOffK + kStages * kTileBytes;
constexpr uint32_t kOffBar = kOffV + kStages * kTileBytes;  // q, full[], empty[]
constexpr uint32_t kSmemBytes =
    kOffBar + 8 * (1 + 2 * kStages) + kSwizzleBytes;  // + alignment slack
// The producer warpgroup gives its registers to the consumers: of the
// SM's 65536, 512 threads start at 128 each; the producer drops to 24 and
// each consumer takes 160.
constexpr int kProducerRegs = 24, kConsumerRegs = 160;
// Named barrier 1 + w: warpgroup w may issue its products; warpgroup w
// waits on it and its predecessor in the round arrives at it.
constexpr int kTurnBar = 1, kTurnThreads = 256;

// The running max m moves, and O and l are rescaled, only when some row
// of the warp meets a logit more than kRescaleLog2 (log2 units) above
// its m.  This is exact: p = 2^(x - m), l and O all refer to the same m,
// and lse = m + log2 l.  The headroom it costs: p < 2^8, so l < 2^8 n_k
// and |O| < 2^8 n_k max|v| stay far inside float32's range, and P keeps
// bf16's relative precision.  It saves most tiles the rescale of O.
constexpr float kRescaleLog2 = 8.0f;

// Online softmax of one 64 x 128 logit tile in place: s becomes the f32
// numerators p, m (raw logits) and l (this thread's columns) are updated,
// alpha is the factor for O.  Row h of this thread is s[4j + 2h + e], at
// key k0 + 8j + 2t + e for the tile's first key k0.  Returns whether O
// must be rescaled (alpha is set only then).
__device__ __forceinline__ bool online_softmax(float (&s)[64], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2], int k0,
                                               int n_k, float scale_log2) {
  if (k0 + kKTile > n_k) {  // the ragged last tile
    const int col = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + 8 * j + (e & 1) >= n_k) s[4 * j + e] = -CUDART_INF_F;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  bool grow = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // A row's 128 keys lie in the 4 lanes of one quad.
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    grow |= (mx[h] - m[h]) * scale_log2 > kRescaleLog2;
  }
  const bool rescale = __any_sync(0xffffffffu, grow);
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rescale) {
      // Tile 0 holds key 0 < n_k, so mx is finite from it on; m = -inf
      // before it rescales with alpha = 0.
      alpha[h] = exp2_approx((m[h] - mx[h]) * scale_log2);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    mc[h] = m[h] * scale_log2;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(s[4 * j + e], scale_log2, -mc[e >> 1]));
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
  return rescale;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_forward_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     bf16* __restrict__ o, float* __restrict__ lse, int n_q,
                     int n_k, float scale_log2) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(kSwizzleBytes - 1);
  const uint32_t q_bar = base + kOffBar;
  const auto full = [&](int s) { return q_bar + 8 + 8 * s; };
  const auto empty = [&](int s) { return q_bar + 8 + 8 * (kStages + s); };
  const auto k_tile = [&](int i) {
    return base + kOffK + (i % kStages) * kTileBytes;
  };
  const auto v_tile = [&](int i) {
    return base + kOffV + (i % kStages) * kTileBytes;
  };
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
      mbar_expect_tx(q_bar, kQBytes);
      tma_load_tile(base + kOffQ, &map_q, q_bar, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTileBytes);
        tma_load_tile(k_tile(i), &map_k, full(s), i * kKTile, bh);
        tma_load_tile(v_tile(i), &map_v, full(s), i * kKTile, bh);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;  // queries q0 + 64 wg ... + 63
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = q0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const uint32_t q_rows = base + kOffQ + wg * 64 * kRowBytes;
    float o_acc[32];    // from the first tile's product (scale-d off)
    uint32_t pa[8][4] = {};  // P as A fragments, k = the tile's 128 keys
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};

    // Warpgroup 0 takes the first turn.
    if (wg == kConsumerWGs - 1) named_arrive(kTurnBar, kTurnThreads);
    mbar_wait(q_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      mbar_wait(full(i % kStages), (i / kStages) & 1);
      named_sync(kTurnBar + wg, kTurnThreads);
      float s[64];  // 64 queries x 128 keys
      // O's rescale and P's fragments are computed before the fence, not
      // sunk past it to their use.
      keep(o_acc);
      keep(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(s, desc_k(q_rows, kk), desc_k(k_tile(i), kk), kk);
      wgmma_commit();
      // The last tile's PV runs on behind this tile's S.  At tile 0 it is
      // P = 0 times tile 0's V with scale-d off, so O starts at 0 from a
      // wgmma and no branch splits the products (one there made ptxas
      // inject a fence of its own and serialise them: C7520).
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<1>(o_acc, pa[kk], desc_mn(v_tile(i > 0 ? i - 1 : 0), kk),
                    i > 0 || kk > 0);
      wgmma_commit();
      named_arrive(kTurnBar + (wg + 1) % kConsumerWGs, kTurnThreads);
      wgmma_wait<1>();
      keep(s);

      float alpha[2];
      const bool rescale =
          online_softmax(s, m, l, alpha, i * kKTile, n_k, scale_log2);
      wgmma_wait<0>();  // the last tile's PV: its stage can be refilled
      keep(o_acc);
      if (i > 0) release(empty((i - 1) % kStages), lane);
      if (rescale) {
#pragma unroll
        for (int j = 0; j < 32; ++j) o_acc[j] *= alpha[(j >> 1) & 1];
      }
      to_a(pa, s);
    }
    keep(o_acc);
    keep(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs<1>(o_acc, pa[kk], desc_mn(v_tile(n_tiles - 1), kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    keep(o_acc);
    keep(pa);

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.0f / l[h];
      const int r = row + 8 * h;
      if (t == 0 && r < n_q)
        lse[(size_t)bh * n_q + r] = (m[h] * scale_log2 + log2f(l[h])) * kLn2;
    }
    store_rows(o + (size_t)bh * n_q * kD, o_acc, row, n_q, inv);
    // The last warpgroup's last turn opened warpgroup 0's barrier once
    // more.
    if (wg == 0) named_sync(kTurnBar, kTurnThreads);
  }
}

}  // namespace

// q, o (bh, n_q, 64) and k, v (bh, n_k, 64) bf16, lse (bh, n_q) f32, all
// contiguous and 16-byte aligned on the current device; scale multiplies
// the logits (natural units) and must be positive: the row max is taken
// over the raw logits, which is the max of the scaled ones only then
// (flash_forward_cuda folds any other scale into q).  Returns the
// launch's cudaError_t, or kErrTensorMap when a tensor map cannot be
// encoded.
extern "C" int spf_flash_forward(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int n_q, int n_k,
                                 float scale, void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  if (!(scale > 0.0f)) return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  if (!tile_map(&map_q, q, bh, n_q, kQRows) ||
      !tile_map(&map_k, k, bh, n_k, kKTile) ||
      !tile_map(&map_v, v, bh, n_k, kKTile))
    return kErrTensorMap;
  static uint64_t raised = 0;
  const cudaError_t allowed =
      allow_smem(flash_forward_kernel, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((n_q + kQRows - 1) / kQRows), (unsigned)bh);
  flash_forward_kernel<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<bf16*>(o), static_cast<float*>(lse),
      n_q, n_k, scale * kLog2e);
  return (int)cudaGetLastError();
}
