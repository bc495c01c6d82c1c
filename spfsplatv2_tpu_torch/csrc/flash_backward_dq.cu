// K5, backward dQ: the gradient of exact softmax attention over
// (b, h, n, 64) bf16 with respect to the queries.
//
// Replaces jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_dq_kernel (launched at :1456), the second half of the
// custom VJP _flash_attention_bwd (:254-321).  P is rebuilt from the
// forward's saved log-sum-exp; di = rowsum(dO * O) comes from outside.
//
// One CTA of 4 warps per (query tile of 64 rows, batch * head); each warp
// keeps its 16 rows of Q and dO as A fragments in registers, with its
// rows' lse and di, and loops over every key tile inside the block (the
// TPU kernel's sequential grid axis), so dQ is written once, with no
// atomics.  Per key tile, with K, K transposed and V staged in shared
// memory:
//   S = Q K^T, P = exp2(S * scale * log2e - lse * log2e), 0 past n_k
//   dP = dO V^T, dS = P (dP - di)
//   dQ += dS K                         (dS rounded to bf16), times scale
// on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate).
//
// What bounds it on an H100: the tensor cores.  The three products are
// 6 * n_q * n_k * 64 FLOPs per head (0.31 TFLOP at the encoder's
// (3, 16, 4096, 64): 0.31 ms at 989 TFLOP/s).  As in the forward, the
// first kernel uses mma.sync and a single-buffered stage.

#include "flash_common.cuh"

namespace {

using namespace flash;

__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                bf16* __restrict__ dq, int n_q, int n_k, float scale,
                float scale_log2) {
  __shared__ __align__(16) bf16 ks[kTileElems];
  __shared__ __align__(16) bf16 kt[kTileElems];
  __shared__ __align__(16) bf16 vs[kTileElems];
  const size_t bh = blockIdx.y;
  q += bh * n_q * kD;
  dout += bh * n_q * kD;
  dq += bh * n_q * kD;
  k += bh * n_k * kD;
  v += bh * n_k * kD;
  lse += bh * n_q;
  di += bh * n_q;
  const int q0 = blockIdx.x * kTile;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;

  // Q and dO of this tile, through the staging buffers, into registers.
  load_tile(ks, q, q0, n_q);
  load_tile(vs, dout, q0, n_q);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_a(qa[kk], ks, r0, kk * 16);
    load_a(da[kk], vs, r0, kk * 16);
  }
  float lse_r[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    lse_r[i] = row < n_q ? lse[row] * kLog2e : CUDART_INF_F;
    di_r[i] = row < n_q ? di[row] : 0.0f;
  }

  float dq_acc[8][4];
  zero(dq_acc);

  for (int k0 = 0; k0 < n_k; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous key tile
    load_tile(ks, k, k0, n_k);
    load_tile_t(kt, k, k0, n_k);
    load_tile(vs, v, k0, n_k);
    __syncthreads();

    float p[8][4];
    zero(p);
    mma_16x64x64(p, qa, ks);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        p[nt][e] = key < n_k
                       ? exp2f(p[nt][e] * scale_log2 - lse_r[e >> 1])
                       : 0.0f;
      }

    float ds[8][4];
    zero(ds);
    mma_16x64x64(ds, da, vs);  // dP
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = p[nt][e] * (ds[nt][e] - di_r[e >> 1]);

    uint32_t a[4][4];
    to_a(a, ds);
    mma_16x64x64(dq_acc, a, kt);
  }

  const float sc[2] = {scale, scale};
  store_rows(dq, dq_acc, q0 + r0, n_q, sc);
}

}  // namespace

// q, dout, dq (bh, n_q, 64) and k, v (bh, n_k, 64) bf16; lse and di
// (bh, n_q) f32 (lse in natural units); all contiguous and 16-byte
// aligned on the current device.
extern "C" int spf_flash_backward_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* di,
                                     void* dq, int bh, int n_q, int n_k,
                                     float scale, void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n_q + kTile - 1) / kTile), (unsigned)bh);
  flash_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<bf16*>(dq), n_q, n_k, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}
