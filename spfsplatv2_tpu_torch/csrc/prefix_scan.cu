// K3: inclusive prefix sum of a 1-D int32 or float32 array.
//
// Replaces the Pallas TPU kernel spfsplatv2_tpu/ops/segscan.py:_cumsum_kernel
// (launched by cumsum_1d).  On the TPU the grid runs in order on one core,
// so that kernel carries the running sum in scratch from one 256-lane
// block to the next.  Blocks of a CUDA grid run in no order, so the carry
// becomes a three-phase block scan:
//   1. scan_blocks: each 1024-thread CTA scans 1024 elements (warp
//      shuffles, then one warp scans the 32 warp totals in shared memory),
//      writes the partial scan and its block total;
//   2. scan_totals: one CTA scans the block totals in place, in passes of
//      1024 with a running carry;
//   3. add_offsets: every CTA but the first adds the total of the blocks
//      before it.
//
// What bounds it on an H100: memory.  At the main path's n = 131072 the
// function must move 1 MiB (read n, write n), under a microsecond at 3.35
// TB/s, so the three launches' fixed cost dominates.  The design keeps
// each phase a single coalesced pass; a decoupled look-back (one pass) is
// later work.  int32 sums are exact; float32 sums are taken in a tree
// order, not torch.cumsum's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    T other = __shfl_up_sync(0xffffffffu, v, offset);
    if (lane >= offset) v += other;
  }
  return v;
}

// Inclusive scan over the kBlock threads of the CTA.  `warp_totals` is
// shared scratch of 32 entries; the caller syncs before reusing it.
template <typename T>
__device__ __forceinline__ T block_inclusive_scan(T v, T* warp_totals) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_inclusive_scan(v);
  if (lane == 31) warp_totals[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T s = warp_totals[lane];  // kBlock / 32 == 32 warps
    warp_totals[lane] = warp_inclusive_scan(s);
  }
  __syncthreads();
  if (warp > 0) v += warp_totals[warp - 1];
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
scan_blocks(const T* __restrict__ in, T* __restrict__ out,
            T* __restrict__ totals, long long n) {
  __shared__ T warp_totals[32];
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  T v = i < n ? in[i] : T(0);
  v = block_inclusive_scan(v, warp_totals);
  if (i < n) out[i] = v;
  if (threadIdx.x == kBlock - 1) totals[blockIdx.x] = v;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
scan_totals(T* __restrict__ totals, long long n_blocks) {
  __shared__ T warp_totals[32];
  __shared__ T pass_total;
  T carry = T(0);
  for (long long base = 0; base < n_blocks; base += kBlock) {
    const long long i = base + threadIdx.x;
    T v = i < n_blocks ? totals[i] : T(0);
    v = block_inclusive_scan(v, warp_totals);
    if (i < n_blocks) totals[i] = v + carry;
    if (threadIdx.x == kBlock - 1) pass_total = v;
    __syncthreads();
    carry += pass_total;
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
add_offsets(T* __restrict__ out, const T* __restrict__ totals, long long n) {
  if (blockIdx.x == 0) return;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i < n) out[i] += totals[blockIdx.x - 1];
}

template <typename T>
int cumsum(const void* in, void* out, void* totals, long long n,
           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_blocks = (n + kBlock - 1) / kBlock;
  T* t = static_cast<T*>(totals);
  scan_blocks<T><<<(unsigned)n_blocks, kBlock, 0, s>>>(
      static_cast<const T*>(in), static_cast<T*>(out), t, n);
  if (n_blocks > 1) {
    scan_totals<T><<<1, kBlock, 0, s>>>(t, n_blocks);
    add_offsets<T><<<(unsigned)n_blocks, kBlock, 0, s>>>(
        static_cast<T*>(out), t, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// `totals` is scratch of ceil(n / 1024) elements of the input's type.
extern "C" int spf_cumsum_i32(const void* in, void* out, void* totals,
                              long long n, void* stream) {
  return cumsum<int32_t>(in, out, totals, n, stream);
}

extern "C" int spf_cumsum_f32(const void* in, void* out, void* totals,
                              long long n, void* stream) {
  return cumsum<float>(in, out, totals, n, stream);
}
