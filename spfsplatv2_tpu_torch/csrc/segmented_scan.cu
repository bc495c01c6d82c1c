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
// (prefix_scan.cu), the carry goes through memory in one pass, a decoupled
// look-back, here with the segmented operator
//   (a, fa) + (b, fb) = (fb ? b : a + b, fa | fb),
// where a flag marks a segment start (element 0, or seg[i] != seg[i - 1]):
//   1. each 128-thread CTA takes a tile of kTile = 1024 elements of one row,
//      8 consecutive ones a thread, and scans it (in registers, then warp
//      shuffles, then one warp over the 4 warp totals);
//   2. it publishes its tile's total and whether the tile holds a segment
//      start in its status word.  A tile that holds one publishes its
//      total as its inclusive prefix at once: nothing before it reaches
//      past its first start.  Its first warp then walks back over the
//      predecessors' words, 32 at a time, summing totals until it meets an
//      inclusive one (a tile with a start, or one whose own look-back has
//      ended), and a tile without a start publishes its inclusive prefix;
//   3. every thread adds the tile's prefix to its elements before the
//      first segment start at or before them and stores its 8 sums.
// A status word is 64 bits, written and read whole: the value's 32 bits
// and the state (0 unwritten, 1 total, 2 inclusive) above them.  The
// C entry zeroes the words with cudaMemsetAsync on the call's stream, so
// a call needs no state from another and can be captured in a CUDA graph
// (the memset and the kernel are two nodes; a replay zeroes again).  CTAs
// take their tile from a ticket counter (atomicAdd), in the order they
// start, so a tile only ever waits for tiles that have started; tickets
// run tile-major over the rows, so the R rows of one tile read the same
// ids back to back, mostly from L2.
//
// What bounds it on an H100: memory.  At the flagship's e_pad = 524416 and
// R = 10 the function must read 21 MB of values and 2 MB of ids and write
// 21 MB (13.2 us at 3.35 TB/s); one launch (instead of three) and short
// look-backs are what the design buys.  Small tiles keep many CTAs, and
// their loads, in flight on each SM: on the H100, at that shape, tiles of
// 1024 elements ran faster than tiles of 2048 or 4096 (with 4, 8 or 16
// elements a thread).  Sums are taken in a tree order within a tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr uint32_t kTotal = 1, kInclusive = 2;

__device__ __forceinline__ void store_word(unsigned long long* at,
                                           unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(at), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* at) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(w)
               : "l"(at)
               : "memory");
  return w;
}

__device__ __forceinline__ unsigned long long word(uint32_t state, float v) {
  return ((unsigned long long)state << 32) | __float_as_uint(v);
}

// (v, f) becomes (pv, pf) + (v, f), for the pair just before it.
__device__ __forceinline__ void combine(float pv, int pf, float& v, int& f) {
  if (!f) v += pv;
  f |= pf;
}

// Inclusive segmented scan over the 32 lanes of a warp.
__device__ __forceinline__ void warp_seg_scan(float& v, int& f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const float vo = __shfl_up_sync(0xffffffffu, v, offset);
    const int fo = __shfl_up_sync(0xffffffffu, f, offset);
    if (lane >= offset) combine(vo, fo, v, f);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// The segmented sum of a row's elements before tile `tile` (the tiles'
// words at state[0 .. tile - 1]), by the first warp: read the 32 words
// below the window's top until those from the nearest up to the nearest
// inclusive one (or all 32) are written, add their values, and move the
// window down unless one was inclusive.
__device__ __forceinline__ float look_back(const unsigned long long* state,
                                           int tile) {
  const int lane = threadIdx.x & 31;
  float prefix = 0.0f;
  for (int top = tile - 1;; top -= 32) {
    const int at = top - lane;  // lane 0 is the nearest predecessor
    unsigned long long w;
    uint32_t inclusive;
    int stop;
    for (;;) {
      // Below tile 0 counts as an inclusive prefix of 0.
      w = at >= 0 ? load_word(state + at) : word(kInclusive, 0.0f);
      const uint32_t st = (uint32_t)(w >> 32);
      const uint32_t unwritten = __ballot_sync(0xffffffffu, st == 0);
      inclusive = __ballot_sync(0xffffffffu, st == kInclusive);
      stop = inclusive ? __ffs(inclusive) - 1 : 31;
      // Lanes 0 .. stop must be written; beyond stop nothing is read.
      if ((unwritten & (0xffffffffu >> (31 - stop))) == 0) break;
    }
    prefix += warp_sum(lane <= stop ? __uint_as_float((uint32_t)w) : 0.0f);
    if (inclusive) return prefix;
  }
}

__global__ void __launch_bounds__(kThreads)
seg_scan_kernel(const float* __restrict__ vals, const int32_t* __restrict__ seg,
                float* __restrict__ out, unsigned long long* __restrict__ state,
                unsigned int* __restrict__ ticket, long long n, int n_tiles,
                int rows) {
  __shared__ float warp_v[kWarps];
  __shared__ int warp_f[kWarps];
  __shared__ float tile_prefix;
  __shared__ int taken;
  if (threadIdx.x == 0) taken = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = taken / rows, row = taken % rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = (long long)tile * kTile + threadIdx.x * kItems;
  const float* in = vals + row * n;
  float* dst = out + row * n;
  unsigned long long* words = state + (long long)row * n_tiles;

  // 1. This thread's 8 elements and their start flags, scanned in
  // registers.  Past n: zeros that start no segment (nothing reads them).
  float v[kItems];
  int32_t id[kItems];
  const bool whole = first + kItems <= n &&
                     ((uintptr_t)(in + first) & 15) == 0 &&
                     ((uintptr_t)(dst + first) & 15) == 0 &&
                     ((uintptr_t)(seg + first) & 15) == 0;
  if (whole) {
#pragma unroll
    for (int j = 0; j < kItems; j += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(in + first + j));
      const int4 c = __ldg(reinterpret_cast<const int4*>(seg + first + j));
      v[j] = a.x, v[j + 1] = a.y, v[j + 2] = a.z, v[j + 3] = a.w;
      id[j] = c.x, id[j + 1] = c.y, id[j + 2] = c.z, id[j + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in_row = first + j < n;
      v[j] = in_row ? in[first + j] : 0.0f;
      id[j] = in_row ? seg[first + j] : 0;
    }
  }
  int start = 0;  // bit j: element j starts a segment
  {
    int32_t before = first == 0 ? 0 : (first < n ? seg[first - 1] : 0);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in_row = first + j < n;
      if (in_row && (first + j == 0 || id[j] != before)) start |= 1 << j;
      before = id[j];
    }
  }
#pragma unroll
  for (int j = 1; j < kItems; ++j)
    if (!(start >> j & 1)) v[j] += v[j - 1];

  // The threads' totals: an exclusive segmented scan over the CTA.
  float incl = v[kItems - 1];
  int incl_f = start != 0;
  warp_seg_scan(incl, incl_f);
  float before_v = __shfl_up_sync(0xffffffffu, incl, 1);
  int before_f = __shfl_up_sync(0xffffffffu, incl_f, 1);
  if (lane == 0) before_v = 0.0f, before_f = 0;
  if (lane == 31) warp_v[warp] = incl, warp_f[warp] = incl_f;
  __syncthreads();
  if (warp == 0) {
    float total = lane < kWarps ? warp_v[lane] : 0.0f;
    int total_f = lane < kWarps ? warp_f[lane] : 0;
    warp_seg_scan(total, total_f);
    if (lane < kWarps) warp_v[lane] = total, warp_f[lane] = total_f;
    // 2. Publish the tile's total, then its inclusive prefix.
    const float aggregate = __shfl_sync(0xffffffffu, total, kWarps - 1);
    const int any_start = __shfl_sync(0xffffffffu, total_f, kWarps - 1);
    if (lane == 0)
      store_word(words + tile,
                 word(tile == 0 || any_start ? kInclusive : kTotal, aggregate));
    const float prefix = tile == 0 ? 0.0f : look_back(words, tile);
    if (lane == 0) {
      if (tile > 0 && !any_start)
        store_word(words + tile, word(kInclusive, prefix + aggregate));
      tile_prefix = prefix;
    }
  }
  __syncthreads();

  // 3. Add everything before this thread up to its first start and store.
  float carry = tile_prefix;
  if (warp > 0) {
    float wv = warp_v[warp - 1];
    int wf = warp_f[warp - 1];
    combine(carry, 0, wv, wf);
    carry = wv;
  }
  combine(carry, 0, before_v, before_f);
  carry = before_v;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if ((start & ((2 << j) - 1)) == 0) v[j] += carry;
  }
  if (whole) {
#pragma unroll
    for (int j = 0; j < kItems; j += 4)
      *reinterpret_cast<float4*>(dst + first + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (first + j < n) dst[first + j] = v[j];
  }
}

}  // namespace

// vals/out (rows, n) f32, seg (n,) i32 non-decreasing; state holds
// rows * ceil(n / 1024) + 1 64-bit words of scratch (the status words and
// the ticket counter), zeroed here on the stream; all contiguous on the
// current device.
extern "C" int spf_segmented_scan(const void* vals, const void* seg,
                                  void* out, void* state, int rows,
                                  long long n, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles * rows > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* words = static_cast<unsigned long long*>(state);
  const long long n_words = n_tiles * rows;
  const cudaError_t zeroed =
      cudaMemsetAsync(words, 0, (n_words + 1) * sizeof(*words), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  seg_scan_kernel<<<(unsigned)n_words, kThreads, 0, s>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(seg),
      static_cast<float*>(out), words,
      reinterpret_cast<unsigned int*>(words + n_words), n, (int)n_tiles, rows);
  return (int)cudaGetLastError();
}
