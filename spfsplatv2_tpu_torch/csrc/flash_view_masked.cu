// View-masked attention forward: exact softmax attention over (b, h, n, 64)
// bf16 under an additive (vq, vk) view mask, token r of a sequence
// belonging to view r / l; float32 logits and accumulation, writing O and
// each row's log-sum-exp.
//
// Replaces no TPU kernel: JAX's `spfsplatv2_tpu/ops/attention.py:
// sdpa_view_masked` is plain jnp (a dense einsum, a float32 softmax over
// the masked logits, an einsum).  The CroCo decoders' cross-attention
// (`models/croco/backbone.py:MultiViewCrossAttention`) calls it over every
// view's tokens; at 1024^2 a view has 4,097 or 4,098 tokens and the dense
// form writes b h n_q n_k logits and walks them seven times in float32,
// most of them masked.  This kernel writes none.
//
// The mask is 0 or -inf per (query view, key view): a query view sees a
// few key views, blocks of l contiguous keys.  One CTA owns 192 query rows
// of one (batch, head), which span one or a few query views.  Warp 0 reads
// their mask rows and takes the union of the key views any of them
// allows (a bitmask, vk <= 64); its runs of contiguous views are key
// ranges [a l, b l), and the CTA streams K/V tiles of 128 keys over those
// ranges only, each run's first tile starting at the run's first key (TMA
// takes any row).  Keys past a run's end in its last tile are masked by
// index, as K5 masks n_k.  Nothing is read from the host, so the kernel
// can be captured in a CUDA graph.
//
// Each row adds its own mask entry for the tile's key view, in log2 units:
// where a tile lies in one key view that is one number a row, folded into
// the row's max and into the exponent's offset, so it costs nothing per
// logit.  A tile that crosses a view boundary and meets, for some row of
// a warp, two different entries (the CTA's rows span query views with
// different allowed sets, or an entry is finite and non-zero) adds the
// entries logit by logit; at the served shapes that is one or two tiles
// of the one CTA a head whose rows cross a query view.  A row blocked on
// every tile so far keeps m = -inf and p = 0 (the exponent's offset takes
// m = 0 there, never -inf - -inf); a row with no allowed key view ends
// with l = 0 and O = 0 / 0 = NaN, as the dense form's softmax over -inf
// gives.
//
// Everything else is K5's forward (csrc/flash_forward.cu): the producer
// warpgroup streams K and V through a ring of kStages stages, three
// consumer warpgroups of 64 query rows take turns on the tensor cores
// (S = Q K^T, then O = alpha O + P V with P rounded to bf16, the sum l
// taken from the float32 p), one ex2 per logit, O rescaled only when a
// row's max rises by more than 2^8.  The running max m is kept in log2
// units of the masked logits, lse = (m + log2 l) ln 2.  What bounds it on
// an H100: as K5, the tensor cores and the exponent unit about equally,
// over the allowed keys only (4 n_q n_k' 64 FLOPs, n_k' the keys a row
// may see, and n_q n_k' ex2).  Query rows at or past n_q are computed and
// never stored.

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kConsumerWGs = 3;
constexpr int kQRows = 64 * kConsumerWGs;    // query rows per CTA
constexpr int kKTile = 128;                  // key rows per ring stage
constexpr int kStages = 4;
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 128;   // and a producer warpgroup
constexpr int kMaxViews = 64;                // key views: one bit each
constexpr uint32_t kQBytes = kQRows * kRowBytes;
constexpr uint32_t kTileBytes = kKTile * kRowBytes;
constexpr uint32_t kOffQ = 0;
constexpr uint32_t kOffK = kOffQ + kQBytes;
constexpr uint32_t kOffV = kOffK + kStages * kTileBytes;
constexpr uint32_t kOffBar = kOffV + kStages * kTileBytes;  // q, full[], empty[]
constexpr uint32_t kOffAllowed = kOffBar + 8 * (1 + 2 * kStages);
constexpr uint32_t kSmemBytes =
    kOffAllowed + 8 + kSwizzleBytes;  // + alignment slack
constexpr int kProducerRegs = 24, kConsumerRegs = 160;
constexpr int kTurnBar = 1, kTurnThreads = 256;
constexpr float kRescaleLog2 = 8.0f;

// The key tiles of one CTA: kKTile keys at a time over each run of
// contiguous allowed key views, from the run's first key.  The producer
// and every consumer thread walk the same sequence.
struct Walk {
  uint64_t rest;  // allowed views whose run has not started
  int k, end;     // the next tile's first key; the current run's end
  int v, vend;    // the key view of key k; the first key of view v + 1
  int l;

  __device__ Walk(uint64_t allowed, int tokens)
      : rest(allowed), k(0), end(0), v(0), vend(0), l(tokens) {}

  // The next tile's keys [k0, k1) and the view of k0; false at the end.
  __device__ bool next(int& k0, int& k1, int& view) {
    if (k >= end) {
      if (rest == 0) return false;
      const int a = __ffsll((long long)rest) - 1;
      const uint64_t from_a = ~(rest >> a);  // the first zero: the run's end
      const int b = from_a == 0 ? 64 : a + __ffsll((long long)from_a) - 1;
      rest = b >= 64 ? 0 : (rest >> b) << b;
      k = a * l;
      end = b * l;
      v = a;
      vend = k + l;
    }
    while (k >= vend) {
      ++v;
      vend += l;
    }
    k0 = k;
    k1 = min(k + kKTile, end);
    view = v;
    k += kKTile;
    return true;
  }
};

__device__ int count_tiles(uint64_t allowed, int l) {
  Walk w(allowed, l);
  int n = 0, k0, k1, view;
  while (w.next(k0, k1, view)) ++n;
  return n;
}

// Online softmax of one 64 x 128 logit tile in place, keys [k0, k1) of
// which k0 lies in key view `view`: s becomes the f32 numerators p, m
// (log2 units of the masked logits) and l (this thread's columns) are
// updated, alpha is the factor for O.  Row h of this thread is
// s[4j + 2h + e], at key k0 + 8j + 2t + e; its mask row is mrow[h], and
// bias[h] holds its entry for `view` in log2 units.  Returns whether O
// must be rescaled (alpha is set only then).
__device__ __forceinline__ bool online_softmax(
    float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2], int k0,
    int k1, int view, int lv, const float* const (&mrow)[2],
    const float (&bias)[2], float scale_log2) {
  const int col0 = 2 * (threadIdx.x & 3);
  const int valid = k1 - k0;
  if (valid < kKTile) {  // a run's ragged last tile
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col0 + 8 * j + (e & 1) >= valid) s[4 * j + e] = -CUDART_INF_F;
  }
  float sl = scale_log2, b[2] = {bias[0], bias[1]};
  // Views past `view` in this tile: where one of them holds another entry
  // for a row of this warp, the entries are added logit by logit.
  const int first_next = (view + 1) * lv - k0;
  bool mixed = false;
  for (int w = view + 1, lo = first_next; lo < valid; ++w, lo += lv)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mixed |= __float_as_uint(__ldg(mrow[h] + w)) !=
               __float_as_uint(__ldg(mrow[h] + view));
  if (__any_sync(0xffffffffu, mixed)) {
    for (int w = view, lo = first_next - lv; lo < valid; ++w, lo += lv) {
      const float c[2] = {__ldg(mrow[0] + w) * kLog2e,
                          __ldg(mrow[1] + w) * kLog2e};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + 8 * j + (e & 1);
          if (col >= lo && col < lo + lv && col < valid)
            s[4 * j + e] = fmaf(s[4 * j + e], scale_log2, c[e >> 1]);
        }
    }
    sl = 1.0f;
    b[0] = b[1] = 0.0f;
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  bool grow = false;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // This tile's max in log2 units (sl > 0); -inf for a blocked row.
    mx[h] = fmaf(mx[h], sl, b[h]);
    grow |= mx[h] - m[h] > kRescaleLog2;  // false where both are -inf
  }
  const bool rescale = __any_sync(0xffffffffu, grow);
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rescale) {
      const float nm = fmaxf(m[h], mx[h]);
      alpha[h] = nm == m[h] ? 1.0f : exp2_approx(m[h] - nm);
      m[h] = nm;
      l[h] *= alpha[h];
    }
    // p = 2^(s sl + b - m); a row with m = -inf has met only masked
    // logits, and takes 0 for m so that its p stay 0.
    mc[h] = b[h] - (m[h] == -CUDART_INF_F ? 0.0f : m[h]);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(s[4 * j + e], sl, mc[e >> 1]));
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
  return rescale;
}

__global__ void __launch_bounds__(kThreads, 1)
view_masked_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const float* __restrict__ mask, bf16* __restrict__ o,
                       float* __restrict__ lse, int n_q, int vk, int lv,
                       float scale_log2) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kSwizzleBytes - 1) & ~(kSwizzleBytes - 1);
  uint64_t* allowed_views =
      reinterpret_cast<uint64_t*>(smem_raw + (base - raw) + kOffAllowed);
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

  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      mbar_init(q_bar, 1);
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), kConsumers / 32);
      }
      mbar_fence_init();
    }
    // The key views that some query view of this CTA's rows may see.
    const int qv_lo = q0 / lv;
    const int entries = (min(q0 + kQRows, n_q) - 1) / lv - qv_lo + 1;
    uint32_t bits[2] = {0u, 0u};
    for (int i = threadIdx.x; i < entries * vk; i += 32) {
      const int kv = i % vk;
      if (mask[(size_t)(qv_lo + i / vk) * vk + kv] != -CUDART_INF_F)
        bits[kv >> 5] |= 1u << (kv & 31);
    }
    bits[0] = __reduce_or_sync(0xffffffffu, bits[0]);
    bits[1] = __reduce_or_sync(0xffffffffu, bits[1]);
    if (threadIdx.x == 0) *allowed_views = ((uint64_t)bits[1] << 32) | bits[0];
  }
  __syncthreads();
  const uint64_t allowed = *allowed_views;
  const int n_tiles = count_tiles(allowed, lv);

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      mbar_expect_tx(q_bar, kQBytes);
      tma_load_tile(base + kOffQ, &map_q, q_bar, q0, bh);
      Walk walk(allowed, lv);
      int k0, k1, view;
      for (int i = 0; walk.next(k0, k1, view); ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTileBytes);
        tma_load_tile(k_tile(i), &map_k, full(s), k0, bh);
        tma_load_tile(v_tile(i), &map_v, full(s), k0, bh);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = q0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    bf16* out = o + (size_t)bh * n_q * kD;
    if (n_tiles == 0) {
      // No row of this CTA sees any key: O = 0 / 0, as the dense form.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= n_q) continue;
        if (t == 0) lse[(size_t)bh * n_q + r] = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(out + (size_t)r * kD + 8 * j + 2 * t) =
              pack_bf16(CUDART_NAN_F, CUDART_NAN_F);
      }
      return;
    }
    const float* const mrow[2] = {
        mask + (size_t)(min(row, n_q - 1) / lv) * vk,
        mask + (size_t)(min(row + 8, n_q - 1) / lv) * vk};
    const uint32_t q_rows = base + kOffQ + wg * 64 * kRowBytes;
    float o_acc[32];
    uint32_t pa[8][4] = {};
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
    int bias_view = -1;
    float bias[2];
    Walk walk(allowed, lv);

    if (wg == kConsumerWGs - 1) named_arrive(kTurnBar, kTurnThreads);
    mbar_wait(q_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      int k0, k1, view;
      walk.next(k0, k1, view);
      if (view != bias_view) {
        bias_view = view;
        bias[0] = __ldg(mrow[0] + view) * kLog2e;
        bias[1] = __ldg(mrow[1] + view) * kLog2e;
      }
      mbar_wait(full(i % kStages), (i / kStages) & 1);
      named_sync(kTurnBar + wg, kTurnThreads);
      float s[64];
      keep(o_acc);
      keep(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(s, desc_k(q_rows, kk), desc_k(k_tile(i), kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<1>(o_acc, pa[kk], desc_mn(v_tile(i > 0 ? i - 1 : 0), kk),
                    i > 0 || kk > 0);
      wgmma_commit();
      named_arrive(kTurnBar + (wg + 1) % kConsumerWGs, kTurnThreads);
      wgmma_wait<1>();
      keep(s);

      float alpha[2];
      const bool rescale = online_softmax(s, m, l, alpha, k0, k1, view, lv,
                                          mrow, bias, scale_log2);
      wgmma_wait<0>();
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
      inv[h] = 1.0f / l[h];  // inf for a row that sees no key: O = NaN
      const int r = row + 8 * h;
      if (t == 0 && r < n_q)
        lse[(size_t)bh * n_q + r] = (m[h] + log2f(l[h])) * kLn2;
    }
    store_rows(out, o_acc, row, n_q, inv);
    if (wg == 0) named_sync(kTurnBar, kTurnThreads);
  }
}

}  // namespace

// q, o (bh, n_q, 64) and k, v (bh, n_k, 64) bf16, lse (bh, n_q) f32, all
// contiguous and 16-byte aligned on the current device; mask (vq, vk)
// float32 contiguous on the device, additive, 0 or -inf per (query view,
// key view), with n_q = vq l and n_k = vk l, vk <= 64; scale multiplies
// the logits (natural units) and must be positive (the wrapper folds any
// other scale into q).  Returns the launch's cudaError_t, or
// kErrTensorMap when a tensor map cannot be encoded.
extern "C" int spf_flash_view_masked(const void* q, const void* k,
                                     const void* v, const void* mask, void* o,
                                     void* lse, int bh, int n_q, int n_k,
                                     int vq, int vk, int l, float scale,
                                     void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  if (!(scale > 0.0f) || l <= 0 || vk <= 0 || vk > kMaxViews ||
      (long long)vq * l != n_q || (long long)vk * l != n_k)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  if (!tile_map(&map_q, q, bh, n_q, kQRows) ||
      !tile_map(&map_k, k, bh, n_k, kKTile) ||
      !tile_map(&map_v, v, bh, n_k, kKTile))
    return kErrTensorMap;
  static uint64_t raised = 0;
  const cudaError_t allowed =
      allow_smem(view_masked_fwd_kernel, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((n_q + kQRows - 1) / kQRows), (unsigned)bh);
  view_masked_fwd_kernel<<<grid, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<const float*>(mask),
      static_cast<bf16*>(o), static_cast<float*>(lse), n_q, vk, l,
      scale * kLog2e);
  return (int)cudaGetLastError();
}
