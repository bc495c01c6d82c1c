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
// carries dK/dV in scratch between grid steps.  Here one CTA of 4 warps
// owns a key tile of 64 rows (16 per warp, K and V kept as A fragments
// in registers) for one (batch, head) and loops over every query tile
// inside the block, so dK and dV are written once, with no atomics.  Per
// query tile, with Q, dO and their transposes staged in shared memory:
//   S^T = K Q^T, P^T = exp2(S^T * scale * log2e - lse * log2e)
//   dV += P^T dO                       (P^T rounded to bf16)
//   dP^T = V dO^T, dS^T = P^T (dP^T - di)
//   dK += dS^T Q                       (dS^T rounded to bf16), times scale
// on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate).
// Query rows past n_q are staged as zeros with lse = +inf and di = 0, so
// their P and dS are 0; key rows past n_k are computed and not written.
//
// What bounds it on an H100: the tensor cores.  The four products are
// 8 * n_q * n_k * 64 FLOPs per head (0.41 TFLOP at the encoder's
// (3, 16, 4096, 64): 0.42 ms at 989 TFLOP/s) over a few hundred MB.  This
// first kernel uses mma.sync and a single-buffered stage; wgmma, TMA and
// overlapping the next tile's copy are later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int n_q,
                 int n_k, float scale, float scale_log2) {
  __shared__ __align__(16) bf16 qs[kTileElems];
  __shared__ __align__(16) bf16 qt[kTileElems];
  __shared__ __align__(16) bf16 dos[kTileElems];
  __shared__ __align__(16) bf16 dot[kTileElems];
  __shared__ float lse_s[kTile];
  __shared__ float di_s[kTile];
  const size_t bh = blockIdx.y;
  q += bh * n_q * kD;
  dout += bh * n_q * kD;
  k += bh * n_k * kD;
  v += bh * n_k * kD;
  dk += bh * n_k * kD;
  dv += bh * n_k * kD;
  lse += bh * n_q;
  di += bh * n_q;
  const int k0 = blockIdx.x * kTile;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int t = threadIdx.x & 3;

  // K and V of this tile, through the staging buffers, into registers.
  load_tile(qs, k, k0, n_k);
  load_tile(dos, v, k0, n_k);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_a(ka[kk], qs, r0, kk * 16);
    load_a(va[kk], dos, r0, kk * 16);
  }

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int q0 = 0; q0 < n_q; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous query tile
    load_tile(qs, q, q0, n_q);
    load_tile_t(qt, q, q0, n_q);
    load_tile(dos, dout, q0, n_q);
    load_tile_t(dot, dout, q0, n_q);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool real = q0 + i < n_q;
      lse_s[i] = real ? lse[q0 + i] * kLog2e : CUDART_INF_F;
      di_s[i] = real ? di[q0 + i] : 0.0f;
    }
    __syncthreads();

    float p[8][4];
    zero(p);
    mma_16x64x64(p, ka, qs);  // S^T: rows are keys, columns queries
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[nt][e] = exp2f(p[nt][e] * scale_log2 - lse_s[nt * 8 + 2 * t + (e & 1)]);

    uint32_t a[4][4];
    to_a(a, p);
    mma_16x64x64(dv_acc, a, dot);

    float ds[8][4];
    zero(ds);
    mma_16x64x64(ds, va, dos);  // dP^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = p[nt][e] * (ds[nt][e] - di_s[nt * 8 + 2 * t + (e & 1)]);

    to_a(a, ds);
    mma_16x64x64(dk_acc, a, qt);
  }

  const float one[2] = {1.0f, 1.0f};
  const float sc[2] = {scale, scale};
  store_rows(dv, dv_acc, k0 + r0, n_k, one);
  store_rows(dk, dk_acc, k0 + r0, n_k, sc);
}

}  // namespace

// q, dout (bh, n_q, 64) and k, v, dk, dv (bh, n_k, 64) bf16; lse and di
// (bh, n_q) f32 (lse in natural units); all contiguous and 16-byte
// aligned on the current device.
extern "C" int spf_flash_backward_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dk, void* dv, int bh, int n_q,
                                      int n_k, float scale, void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n_k + kTile - 1) / kTile), (unsigned)bh);
  flash_dkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_q, n_k, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}
