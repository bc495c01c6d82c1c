// K5, forward, float32: exact softmax attention over (b, h, n, 64) float32
// with float32 products and sums, writing O and each row's log-sum-exp.
//
// Replaces the forward of JAX's bundled TPU flash attention,
// jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_kernel (launched at :758), for float32 inputs, which
// spfsplatv2_tpu/ops/attention.py:sdpa hands it under
// CrocoBackboneConfig.compute_dtype = "float32" once n_k >= FLASH_MIN_KV.
// Given float32, the TPU kernel's products run in float32 with float32
// accumulation and nothing is rounded; so here.  Like the bf16 kernel
// (flash_forward.cu) it takes the real lengths and masks the ragged last
// key tile by index (4098 keys are no multiple of any tile).
//
// One CTA owns 64 query rows of one (batch, head), with Q in shared
// memory, and walks every key tile of 64 (the TPU kernel's sequential
// grid axis), on FP32 FMAs through flash_f32_common.cuh's register
// micro-tiles:
//   S = Q K^T              a thread's 4 query rows x 4 keys
//   online softmax         running row max m (log2 units, one exp2f a
//                          logit, the max over 16 threads by shuffles)
//                          and the thread's part of the row sum l
//   O = alpha O + P V      P through shared memory
// O is scaled by 1/l when stored, lse = (m + log2 l) ln 2.
//
// What bounds it on an H100: the FP32 FMA units.  The two products are
// 4 * n_q * n_k * 64 FLOPs per head (0.21 TFLOP at the encoder's
// (3, 16, 4096, 64): 3.08 ms at 67 TFLOP/s); the ex2 a logit (0.21 ms at
// ~3.9 T/s) and the 100 MB of inputs and outputs are far below that.
// The design keeps every shared read a conflict-free float4 (8 FMAs a
// read) and is simple first: no cp.async pipelining, no 3xTF32 split on
// the tensor cores (later work).

#include "flash_f32_common.cuh"

namespace {

using namespace flash_f32;

constexpr int kSmemBytes = 4 * kTileFloats * (int)sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
flash_f32_forward_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int n_q, int n_k,
                         float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kTileFloats;
  float* vs = ks + kTileFloats;
  float* ps = vs + kTileFloats;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t head = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const float* kg = k + head * n_k * kD;
  const float* vg = v + head * n_k * kD;

  load_tile(qs, q + head * n_q * kD, q0, n_q);
  float acc[4][4], m[4], l[4];
  zero(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int kv0 = 0; kv0 < n_k; kv0 += kTile) {
    __syncthreads();  // the last tile's P V is done with vs and ps
    load_tile(ks, kg, kv0, n_k);
    load_tile(vs, vg, kv0, n_k);
    __syncthreads();
    float s[4][4];
    zero(s);
    product_abt(qs, ks, s);
    const bool ragged = kv0 + kTile > n_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale_log2;
        if (ragged && kv0 + tx + 16 * j >= n_k) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int lane = 1; lane < 16; lane <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, lane));
      // The first tile holds key 0, so m_new is finite from there on.
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= alpha;
        const float p = exp2f(s[i][j] - m_new);
        l[i] += p;
        ps[(ty * 4 + i) * kStride + tx + 16 * j] = p;
      }
    }
    __syncthreads();
    product_ab(ps, vs, acc);
  }
  const size_t row_base = head * n_q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int lane = 1; lane < 16; lane <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], lane);
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= inv;
    const int r = q0 + ty * 4 + i;
    if (tx == 0 && r < n_q) lse[row_base + r] = (m[i] + log2f(l[i])) * kLn2;
  }
  store_rows(o + row_base * kD, q0, n_q, acc, 1.f);
}

}  // namespace

extern "C" int spf_flash_f32_forward(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int bh, int n_q, int n_k, float scale,
                                     void* stream) {
  if (bh <= 0 || n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  static uint64_t raised = 0;
  const cudaError_t allowed = kernel_launch::allow_smem(
      flash_f32_forward_kernel, kSmemBytes, raised);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid((unsigned)((n_q + kTile - 1) / kTile), (unsigned)bh);
  flash_f32_forward_kernel<<<grid, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), n_q, n_k, scale * kLog2e);
  return (int)cudaGetLastError();
}
