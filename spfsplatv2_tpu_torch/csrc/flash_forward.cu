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
// One CTA of 4 warps per (query tile of 64 rows, batch * head).  Each warp
// keeps its 16 query rows as A fragments in registers and walks all key
// tiles: K and V (V transposed) are staged in shared memory, S = Q K^T
// and O += P V run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), and the online softmax (running max and sum per row, in
// log2 units so that exp2f does the exponent) stays in f32 registers.
// P is rounded to bf16 for the PV product, as the TPU kernel casts p to
// v's type.  The sum l takes the f32 p.
//
// What bounds it on an H100: the tensor cores.  4 * n_q * n_k * 64 FLOPs
// per head over ~20 bytes of Q, K, V and O per row; at the encoder's
// (3, 16, 4096, 64) that is 206 GFLOP against 0.2 GB, far above the
// card's ~295 FLOPs per byte, so the bound is 206 GFLOP / 989 TFLOP/s =
// 0.21 ms.  This first kernel uses mma.sync, which reaches only part of
// the wgmma rate, and a single-buffered K/V stage with no copy overlap;
// wgmma, TMA and warp specialisation are later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int n_q, int n_k,
                     float scale_log2) {
  __shared__ __align__(16) bf16 qs[kTileElems];
  __shared__ __align__(16) bf16 ks[kTileElems];
  __shared__ __align__(16) bf16 vt[kTileElems];
  const size_t bh = blockIdx.y;
  q += bh * n_q * kD;
  o += bh * n_q * kD;
  k += bh * n_k * kD;
  v += bh * n_k * kD;
  lse += bh * n_q;
  const int q0 = blockIdx.x * kTile;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;

  load_tile(qs, q, q0, n_q);
  __syncthreads();
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(qa[kk], qs, r0, kk * 16);

  float acc[8][4];
  zero(acc);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.0f, 0.0f};

  for (int k0 = 0; k0 < n_k; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(ks, k, k0, n_k);
    load_tile_t(vt, v, k0, n_k);
    __syncthreads();

    float s[8][4];
    zero(s);
    mma_16x64x64(s, qa, ks);

    // Scale into log2 units, mask keys past n_k, new row maxima.  Row g's
    // values are s[.][0..1], row g + 8's s[.][2..3]; a row's 64 values
    // lie in the 4 lanes of one quad.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = key < n_k ? s[nt][e] * scale_log2 : -CUDART_INF_F;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // The first tile holds key k0 < n_k, so mx is finite from here on;
      // m = -inf then gives alpha = 0.
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
        acc[nt][e] *= alpha[e >> 1];
      }
    }
    uint32_t pa[4][4];
    to_a(pa, s);
    mma_16x64x64(acc, pa, vt);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.0f / l[i];
    const int row = q0 + r0 + g + 8 * i;
    if (t == 0 && row < n_q) lse[row] = (m[i] + log2f(l[i])) * kLn2;
  }
  store_rows(o, acc, q0 + r0, n_q, inv);
}

}  // namespace

// q, o (bh, n_q, 64) and k, v (bh, n_k, 64) bf16, lse (bh, n_q) f32, all
// contiguous and 16-byte aligned on the current device; scale multiplies
// the logits (natural units).
extern "C" int spf_flash_forward(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int n_q, int n_k,
                                 float scale, void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n_q + kTile - 1) / kTile), (unsigned)bh);
  flash_forward_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), n_q, n_k, scale * kLog2e);
  return (int)cudaGetLastError();
}
