// K5, float32, the split pre-passes: the hi and lo tf32 planes that the
// 3xTF32 kernels read, once per call: the forward's (flash_f32_forward.cu)
// and the backward pair's (flash_f32_backward_dkv.cu,
// flash_f32_backward_dq.cu).
//
// Part of the port of jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_kernel (:331), _flash_attention_dkv_kernel (:796) and
// _flash_attention_dq_kernel (:1146); the TPU kernels need no such pass
// (their MXU takes float32 and either operand transposed).  On the H100
// the kernels run on wgmma with tf32 operands, which must be K-major (no
// transpose bit for tf32) and are split into hi = tf32(x), lo = tf32(x -
// hi) (flash_sm90.cuh, 3xTF32).  So, for each (b*h) head, a pass writes
//   x_hl (2, bh, n, 64): hi and lo of x as it lies: the operands whose
//       reduced axis is the head dim (S, dP and their transposes);
//   x_t (2, bh, 64, n8): hi and lo of x transposed, n padded with zeros
//       to n8, the next multiple of 8, and the n axis permuted inside each
//       group of 8 (position L holds row 2L for L < 4, row 2(L - 4) + 1
//       for L >= 4): the B operands of O += P V, dV += P^T dO,
//       dK += dS^T Q and dQ += dS K, whose reduced axis is n and whose A
//       fragments come from accumulators in that order.
// The backward's pass (spf_flash_f32_split) writes x_hl of q, k, v, dO
// and x_t of q, k, dO; the forward's (spf_flash_f32_split_forward) k_hl
// and v_t (the forward splits q in registers).
// ops/attention.py:flash_f32_split_plain and flash_f32_split_forward_plain
// are the same functions in torch; each agrees with its pass bit for bit.
//
// What bounds it on an H100: memory.  The backward's pass reads 4 tensors
// and writes 14 planes of the same size (at the train shape (6, 16,
// 4096, 64): 0.40 GB in, 1.41 GB out, 0.54 ms at 3.35 TB/s); the
// forward's reads 2 and writes 4 (at the encoder's (3, 16, 4096, 64):
// 0.30 GB, 0.090 ms).  One CTA of 256 threads takes 64 rows of one tensor
// of one head: float4 loads and stores for the planes as they lie, and
// the transposed planes through shared memory (rows padded to 65 floats),
// written 64 consecutive floats a row.

#include "flash_sm90.cuh"

namespace {

using sm90::kD;
constexpr int kRows = 64;
constexpr int kThreads = 256;
constexpr int kPad = kD + 1;

// One tensor of a pass: x (bh, n, 64) in, its planes out (either may be
// null: not written).
struct Job {
  const float* x;
  float* hl;
  float* t;
  int n;
};

struct Jobs {
  Job job[4];  // blockIdx.z picks one
};

__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float(sm90::to_tf32(x));
}

__global__ void __launch_bounds__(kThreads)
flash_f32_split_kernel(const __grid_constant__ Jobs jobs) {
  __shared__ float hi_s[kRows * kPad], lo_s[kRows * kPad];
  const Job& job = jobs.job[blockIdx.z];
  const int n = job.n;
  const int r0 = blockIdx.x * kRows;
  if (r0 >= n) return;
  const int n8 = (n + 7) & ~7;
  const size_t bh = gridDim.y, head = blockIdx.y;
  const size_t plane = bh * n * kD;  // lo lies one plane after hi
  const float* x = job.x + head * n * kD;
  float* hl = job.hl == nullptr ? nullptr : job.hl + head * n * kD;

#pragma unroll
  for (int i = 0; i < kRows * kD / 4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 4, c = (idx & 15) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      val = *reinterpret_cast<const float4*>(x + (size_t)(r0 + r) * kD + c);
    const float4 h = make_float4(tf32(val.x), tf32(val.y), tf32(val.z),
                                 tf32(val.w));
    const float4 l = make_float4(tf32(val.x - h.x), tf32(val.y - h.y),
                                 tf32(val.z - h.z), tf32(val.w - h.w));
    if (hl != nullptr && r0 + r < n) {
      *reinterpret_cast<float4*>(hl + (size_t)(r0 + r) * kD + c) = h;
      *reinterpret_cast<float4*>(hl + plane + (size_t)(r0 + r) * kD + c) = l;
    }
    if (job.t != nullptr) {
      float* hs = hi_s + r * kPad + c;
      float* ls = lo_s + r * kPad + c;
      hs[0] = h.x; hs[1] = h.y; hs[2] = h.z; hs[3] = h.w;
      ls[0] = l.x; ls[1] = l.y; ls[2] = l.z; ls[3] = l.w;
    }
  }
  if (job.t == nullptr) return;
  __syncthreads();
  const size_t t_plane = bh * kD * n8;
  float* xt = job.t + head * kD * n8;
#pragma unroll
  for (int i = 0; i < kRows * kD / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int col = idx >> 6, pos = idx & 63;
    if (r0 + pos >= n8) continue;
    const int l8 = pos & 7;
    const int r = (pos & ~7) + (l8 < 4 ? 2 * l8 : 2 * (l8 - 4) + 1);
    float* out = xt + (size_t)col * n8 + r0 + pos;
    out[0] = hi_s[r * kPad + col];
    out[t_plane] = lo_s[r * kPad + col];
  }
}

int launch(const Jobs& jobs, int count, int bh, int n, void* stream) {
  if (bh <= 0 || n <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n + kRows - 1) / kRows), (unsigned)bh,
                  (unsigned)count);
  flash_f32_split_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(jobs);
  return (int)cudaGetLastError();
}

}  // namespace

// q, d_o (bh, n_q, 64) and k, v (bh, n_k, 64) float32; q_hl, do_hl
// (2, bh, n_q, 64), k_hl, v_hl (2, bh, n_k, 64), q_t, do_t (2, bh, 64,
// n8(n_q)) and k_t (2, bh, 64, n8(n_k)) float32; all contiguous on the
// current device.  Returns the launch's cudaError_t.
extern "C" int spf_flash_f32_split(const void* q, const void* k,
                                   const void* v, const void* d_o, void* q_hl,
                                   void* k_hl, void* v_hl, void* do_hl,
                                   void* q_t, void* k_t, void* do_t, int bh,
                                   int n_q, int n_k, void* stream) {
  if (n_q <= 0 || n_k <= 0) return (int)cudaGetLastError();
  const Jobs jobs = {{
      {static_cast<const float*>(q), static_cast<float*>(q_hl),
       static_cast<float*>(q_t), n_q},
      {static_cast<const float*>(k), static_cast<float*>(k_hl),
       static_cast<float*>(k_t), n_k},
      {static_cast<const float*>(v), static_cast<float*>(v_hl), nullptr, n_k},
      {static_cast<const float*>(d_o), static_cast<float*>(do_hl),
       static_cast<float*>(do_t), n_q},
  }};
  return launch(jobs, 4, bh, n_q > n_k ? n_q : n_k, stream);
}

// k, v (bh, n_k, 64) float32; k_hl (2, bh, n_k, 64) and v_t (2, bh, 64,
// n8(n_k)) float32; all contiguous on the current device.  Returns the
// launch's cudaError_t.
extern "C" int spf_flash_f32_split_forward(const void* k, const void* v,
                                           void* k_hl, void* v_t, int bh,
                                           int n_k, void* stream) {
  const Jobs jobs = {{
      {static_cast<const float*>(k), static_cast<float*>(k_hl), nullptr, n_k},
      {static_cast<const float*>(v), nullptr, static_cast<float*>(v_t), n_k},
      {nullptr, nullptr, nullptr, 0},
      {nullptr, nullptr, nullptr, 0},
  }};
  return launch(jobs, 2, bh, n_k, stream);
}
