// K5, backward, dQ, float32: the gradient of exact softmax attention over
// (b, h, n, 64) float32 with respect to Q.
//
// Replaces jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_dq_kernel (launched at :1456) for float32 inputs:
//   P  = exp(Q K^T * scale - lse)      dP = dO V^T
//   dS = P * (dP - di)                 dQ = scale * dS K
// in float32 throughout, dS not rounded (the bf16 kernel,
// flash_backward_dq.cu, rounds it to bf16 for its product).
//
// One CTA owns 64 query rows of one (batch, head), with their Q and dO
// tiles, lse and di in shared memory and dQ in registers, and walks every
// key tile of 64 (K, V); per tile, on FP32 FMAs through
// flash_f32_common.cuh's register micro-tiles, S and dP (a thread's 4
// query rows x 4 keys), then dS through shared memory into dQ (4 query
// rows x 4 of the 64 columns).  Keys at or past n_k (the ragged last
// tile) get P = 0 by index; query rows at or past n_q read as zeros with
// lse = +inf and are never stored.
//
// What bounds it on an H100: the FP32 FMA units, 6 * n_q * n_k * 64 FLOPs
// per head (4.62 ms at the encoder's (3, 16, 4096, 64) at 67 TFLOP/s).
// Five padded tiles of shared memory (87 KB) leave room for two CTAs an
// SM.  Simple first: no pipelining of the next key tile's loads.

#include "flash_f32_common.cuh"

namespace {

using namespace flash_f32;

constexpr int kSmemBytes =
    (5 * kTileFloats + 2 * kTile) * (int)sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
flash_f32_backward_dq_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ d_o,
                             const float* __restrict__ lse,
                             const float* __restrict__ di,
                             float* __restrict__ dq, int n_q, int n_k,
                             float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTileFloats;
  float* ks = dos + kTileFloats;
  float* vs = ks + kTileFloats;
  float* dss = vs + kTileFloats;
  float* lse2 = dss + kTileFloats;
  float* dis = lse2 + kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t head = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const float* kg = k + head * n_k * kD;
  const float* vg = v + head * n_k * kD;
  const float scale_log2 = scale * kLog2e;

  load_tile(qs, q + head * n_q * kD, q0, n_q);
  load_tile(dos, d_o + head * n_q * kD, q0, n_q);
  load_row_stats(lse2, dis, lse + head * n_q, di + head * n_q, q0, n_q);
  float dq_acc[4][4];
  zero(dq_acc);
  for (int kv0 = 0; kv0 < n_k; kv0 += kTile) {
    __syncthreads();  // the last tile's dS K is done with ks and dss
    load_tile(ks, kg, kv0, n_k);
    load_tile(vs, vg, kv0, n_k);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    product_abt(qs, ks, s);
    product_abt(dos, vs, dp);
    const bool ragged = kv0 + kTile > n_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const float row_lse = lse2[row], row_di = dis[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2f(s[i][j] * scale_log2 - row_lse);
        if (ragged && kv0 + tx + 16 * j >= n_k) p = 0.f;
        dss[row * kStride + tx + 16 * j] = p * (dp[i][j] - row_di);
      }
    }
    __syncthreads();
    product_ab(dss, ks, dq_acc);
  }
  store_rows(dq + head * n_q * kD, q0, n_q, dq_acc, scale);
}

}  // namespace

extern "C" int spf_flash_f32_backward_dq(const void* q, const void* k,
                                         const void* v, const void* d_o,
                                         const void* lse, const void* di,
                                         void* dq, int bh, int n_q, int n_k,
                                         float scale, void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  static uint64_t raised = 0;
  const cudaError_t allowed = kernel_launch::allow_smem(
      flash_f32_backward_dq_kernel, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((n_q + kTile - 1) / kTile), (unsigned)bh);
  flash_f32_backward_dq_kernel<<<grid, kThreads, kSmemBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<float*>(dq), n_q, n_k, scale);
  return (int)cudaGetLastError();
}
