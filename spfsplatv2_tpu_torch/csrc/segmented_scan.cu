// K4: segmented inclusive sum scan of each row of a (R, N) float32 array.
//
// Replaces the Pallas TPU kernel spfsplatv2_tpu/ops/segscan.py:_segscan_kernel
// (launched by segmented_scan_lanes).  Along each row the scan restarts
// wherever the non-decreasing segment id seg (N,) int32 changes, so the last
// element of every segment holds that segment's sum; the rasterizer's
// backward reads it at the segment ends (raster_cuda.accumulate_rows under
// SPFSPLAT_ACCUM=segscan).
//
// The TPU kernel carries (value, segment id) from one sequential grid step
// to the next.  Blocks of a CUDA grid run in no order, so, as K3 does
// (prefix_scan.cu), the carry becomes three phases, here with the
// segmented operator (a, fa) + (b, fb) = (fb ? b : a + b, fa | fb), where a
// flag marks a segment start (element 0, or seg[i] != seg[i - 1]):
//   1. seg_scan_blocks: each 1024-thread CTA scans 1024 elements of one row
//      (warp shuffles, then one warp over the 32 warp totals) and writes
//      the partial scan and its block total (last value, any start);
//   2. seg_scan_totals: one CTA per row scans the block totals in place;
//   3. seg_add_carry: every block but the first adds the running sum of
//      the previous blocks to its leading run, the elements whose segment
//      id equals that of the element just before the block.
// The grid's second dimension is the row.  The caller passes only the 10
// real gradient fields (R = 10), not the TPU layout's 16 padded rows.
//
// What bounds it on an H100: memory.  At the flagship's e_pad = 524416 and
// R = 10 the function must read 21 MB of values and 2 MB of ids and write
// 21 MB (~13 us at 3.35 TB/s); phase 3 rereads the ids and rewrites only the
// leading runs.  Sums are taken in a tree order within a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;

__device__ __forceinline__ void warp_seg_scan(float& v, int& f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const float vo = __shfl_up_sync(0xffffffffu, v, offset);
    const int fo = __shfl_up_sync(0xffffffffu, f, offset);
    if (lane >= offset) {
      if (!f) v += vo;
      f |= fo;
    }
  }
}

// Inclusive segmented scan over the kBlock threads of the CTA.  The
// scratch arrays hold 32 entries; the caller syncs before reusing them.
__device__ __forceinline__ void block_seg_scan(float& v, int& f, float* wv,
                                               int* wf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_seg_scan(v, f);
  if (lane == 31) {
    wv[warp] = v;
    wf[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    float a = wv[lane];  // kBlock / 32 == 32 warps
    int b = wf[lane];
    warp_seg_scan(a, b);
    wv[lane] = a;
    wf[lane] = b;
  }
  __syncthreads();
  if (warp > 0) {
    if (!f) v += wv[warp - 1];
    f |= wf[warp - 1];
  }
}

__global__ void __launch_bounds__(kBlock)
seg_scan_blocks(const float* __restrict__ vals, const int32_t* __restrict__ seg,
                float* __restrict__ out, float* __restrict__ tot_v,
                int* __restrict__ tot_f, long long n, long long n_blocks) {
  __shared__ float wv[32];
  __shared__ int wf[32];
  const long long row = blockIdx.y;
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  float v = 0.0f;
  int f = 1;  // past the end: a lone segment that nothing reads
  if (i < n) {
    v = vals[row * n + i];
    f = (i == 0 || seg[i] != seg[i - 1]) ? 1 : 0;
  }
  block_seg_scan(v, f, wv, wf);
  if (i < n) out[row * n + i] = v;
  if (threadIdx.x == kBlock - 1) {
    tot_v[row * n_blocks + blockIdx.x] = v;
    tot_f[row * n_blocks + blockIdx.x] = f;
  }
}

__global__ void __launch_bounds__(kBlock)
seg_scan_totals(float* __restrict__ tot_v, int* __restrict__ tot_f,
                long long n_blocks) {
  __shared__ float wv[32];
  __shared__ int wf[32];
  __shared__ float pass_v;
  __shared__ int pass_f;
  float* tv = tot_v + (long long)blockIdx.x * n_blocks;
  int* tf = tot_f + (long long)blockIdx.x * n_blocks;
  float carry_v = 0.0f;
  int carry_f = 0;
  for (long long base = 0; base < n_blocks; base += kBlock) {
    const long long i = base + threadIdx.x;
    float v = 0.0f;
    int f = 1;
    if (i < n_blocks) {
      v = tv[i];
      f = tf[i];
    }
    block_seg_scan(v, f, wv, wf);
    if (!f) v += carry_v;
    f |= carry_f;
    if (i < n_blocks) {
      tv[i] = v;
      tf[i] = f;
    }
    if (threadIdx.x == kBlock - 1) {
      pass_v = v;
      pass_f = f;
    }
    __syncthreads();
    carry_v = pass_v;
    carry_f = pass_f;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kBlock)
seg_add_carry(float* __restrict__ out, const int32_t* __restrict__ seg,
              const float* __restrict__ tot_v, long long n,
              long long n_blocks) {
  if (blockIdx.x == 0) return;
  const long long row = blockIdx.y;
  const long long first = (long long)blockIdx.x * kBlock;
  const long long i = first + threadIdx.x;
  if (i < n && seg[i] == seg[first - 1])
    out[row * n + i] += tot_v[row * n_blocks + blockIdx.x - 1];
}

}  // namespace

// vals/out (rows, n) f32, seg (n,) i32 non-decreasing; tot_v (rows,
// n_blocks) f32 and tot_f (rows, n_blocks) i32 scratch with n_blocks =
// ceil(n / 1024); all contiguous on the current device.
extern "C" int spf_segmented_scan(const void* vals, const void* seg,
                                  void* out, void* tot_v, void* tot_f,
                                  int rows, long long n, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_blocks = (n + kBlock - 1) / kBlock;
  const dim3 grid((unsigned)n_blocks, (unsigned)rows);
  seg_scan_blocks<<<grid, kBlock, 0, s>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(seg),
      static_cast<float*>(out), static_cast<float*>(tot_v),
      static_cast<int*>(tot_f), n, n_blocks);
  if (n_blocks > 1) {
    seg_scan_totals<<<rows, kBlock, 0, s>>>(
        static_cast<float*>(tot_v), static_cast<int*>(tot_f), n_blocks);
    seg_add_carry<<<grid, kBlock, 0, s>>>(
        static_cast<float*>(out), static_cast<const int32_t*>(seg),
        static_cast<const float*>(tot_v), n, n_blocks);
  }
  return (int)cudaGetLastError();
}
