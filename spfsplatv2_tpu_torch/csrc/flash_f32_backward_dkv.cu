// K5, backward, dK and dV, float32: the gradients of exact softmax
// attention over (b, h, n, 64) float32 with respect to K and V.
//
// Replaces jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_dkv_kernel (launched at :1121) for float32 inputs.  As
// there, P is rebuilt from the forward's log-sum-exp and di = rowsum(dO *
// O) comes from outside (ops/attention.py:_FlashAttention.backward):
//   P  = exp(Q K^T * scale - lse)      dP = dO V^T
//   dS = P * (dP - di)                 dV = P^T dO,  dK = scale * dS^T Q
// in float32 throughout; P and dS are not rounded (the bf16 kernel,
// flash_backward_dkv.cu, rounds them to bf16 for its products).
//
// One CTA owns 64 key rows of one (batch, head), with their K and V tiles
// in shared memory and dK, dV in registers, and walks every query tile of
// 64 (Q, dO, lse, di); per tile, on FP32 FMAs through
// flash_f32_common.cuh's register micro-tiles, S and dP (a thread's 4
// query rows x 4 keys), then P and dS through shared memory into dV and
// dK (a thread's 4 keys x 4 of the 64 columns).  Query rows at or past
// n_q read as zeros with lse = +inf, so their P and dS are 0; key rows at
// or past n_k are computed and never stored.
//
// What bounds it on an H100: the FP32 FMA units, 8 * n_q * n_k * 64 FLOPs
// per head (6.15 ms at the encoder's (3, 16, 4096, 64) at 67 TFLOP/s).
// Registers hold four 4 x 4 tiles (S, dP, dK, dV); six padded tiles of
// shared memory (104 KB) leave room for two CTAs an SM.  Simple first:
// no pipelining of the next query tile's loads.

#include "flash_f32_common.cuh"

namespace {

using namespace flash_f32;

constexpr int kSmemBytes =
    (6 * kTileFloats + 2 * kTile) * (int)sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
flash_f32_backward_dkv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ d_o,
                              const float* __restrict__ lse,
                              const float* __restrict__ di,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int n_q, int n_k, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTileFloats;
  float* qs = vs + kTileFloats;
  float* dos = qs + kTileFloats;
  float* ps = dos + kTileFloats;
  float* dss = ps + kTileFloats;
  float* lse2 = dss + kTileFloats;
  float* dis = lse2 + kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t head = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const float* qg = q + head * n_q * kD;
  const float* dog = d_o + head * n_q * kD;
  const float* lse_g = lse + head * n_q;
  const float* di_g = di + head * n_q;
  const float scale_log2 = scale * kLog2e;

  load_tile(ks, k + head * n_k * kD, k0, n_k);
  load_tile(vs, v + head * n_k * kD, k0, n_k);
  float dk_acc[4][4], dv_acc[4][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int q0 = 0; q0 < n_q; q0 += kTile) {
    __syncthreads();  // the last tile's products are done with the tiles
    load_tile(qs, qg, q0, n_q);
    load_tile(dos, dog, q0, n_q);
    load_row_stats(lse2, dis, lse_g, di_g, q0, n_q);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    product_abt(qs, ks, s);
    product_abt(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const float row_lse = lse2[row], row_di = dis[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] * scale_log2 - row_lse);
        ps[row * kStride + tx + 16 * j] = p;
        dss[row * kStride + tx + 16 * j] = p * (dp[i][j] - row_di);
      }
    }
    __syncthreads();
    product_atb(ps, dos, dv_acc);
    product_atb(dss, qs, dk_acc);
  }
  store_rows(dk + head * n_k * kD, k0, n_k, dk_acc, scale);
  store_rows(dv + head * n_k * kD, k0, n_k, dv_acc, 1.f);
}

}  // namespace

extern "C" int spf_flash_f32_backward_dkv(const void* q, const void* k,
                                          const void* v, const void* d_o,
                                          const void* lse, const void* di,
                                          void* dk, void* dv, int bh, int n_q,
                                          int n_k, float scale, void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  static uint64_t raised = 0;
  const cudaError_t allowed = kernel_launch::allow_smem(
      flash_f32_backward_dkv_kernel, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((n_k + kTile - 1) / kTile), (unsigned)bh);
  flash_f32_backward_dkv_kernel<<<grid, kThreads, kSmemBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<float*>(dk), static_cast<float*>(dv), n_q, n_k, scale);
  return (int)cudaGetLastError();
}
