// K3: inclusive prefix sum of a 1-D int32 or float32 array.
//
// Replaces the Pallas TPU kernel spfsplatv2_tpu/ops/segscan.py:_cumsum_kernel
// (launched by cumsum_1d).  On the TPU the grid runs in order on one core,
// so that kernel carries the running sum in scratch from one 256-lane
// block to the next.  Blocks of a CUDA grid run in no fixed order, so the
// carry goes through memory instead, in one pass (a decoupled look-back,
// as CUB's single-pass scan):
//   1. each 1024-thread CTA loads a tile of kTile = 8192 elements, 8
//      consecutive ones a thread, and scans it (in registers, then warp
//      shuffles, then one warp over the 32 warp totals);
//   2. it publishes its tile's total in its status word ("aggregate"),
//      then its first warp walks back over the predecessors' words, 32 at
//      a time, summing aggregates until it meets an inclusive prefix, and
//      publishes its own ("inclusive");
//   3. every thread adds the tile's prefix and stores its 8 sums.
// A status word is 64 bits, written and read whole: the value's 32 bits,
// then the state (1 aggregate, 2 inclusive) and the call's epoch above it.
// A word from an earlier call carries another epoch and reads as not yet
// written, so no call has to clear the words first: the wrapper keeps one
// buffer a device and stream and gives each call a new epoch.
// The look-back relies on CTAs starting in the order of their index, as
// CUB's does: a tile only waits for tiles below it.
//
// What bounds it on an H100: memory, and below it the launch.  At the main
// path's n = 131072 the function must move 1 MiB (read n, write n), under
// a microsecond at 3.35 TB/s, so one launch (instead of three) and a short
// look-back are what the design buys.  int32 sums are exact (they wrap
// mod 2^32, as the cast of torch.cumsum's int64 result does); float32
// sums are taken in a tree order, not torch.cumsum's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr uint32_t kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ uint32_t to_bits(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t to_bits(float v) {
  return __float_as_uint(v);
}

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b) {
  if constexpr (std::is_same_v<T, float>)
    return __uint_as_float(b);
  else
    return b;
}

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

template <typename T>
__device__ __forceinline__ unsigned long long word(uint32_t epoch,
                                                   uint32_t state, T v) {
  return ((unsigned long long)(epoch << 2 | state) << 32) | to_bits(v);
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int offset = 1; offset < 32; offset <<= 1) {
    const T other = __shfl_up_sync(0xffffffffu, v, offset);
    if (lane >= offset) v += other;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// The sum of the tiles before `tile`, by the first warp: read the 32
// words below the window's top until none is unwritten, add the values
// from the nearest word up to the nearest inclusive one, and move the
// window down unless one was inclusive.
template <typename T>
__device__ __forceinline__ T look_back(const unsigned long long* state,
                                       int tile, uint32_t epoch) {
  const int lane = threadIdx.x & 31;
  T prefix = T(0);
  for (int top = tile - 1;; top -= 32) {
    const int at = top - lane;  // lane 0 is the nearest predecessor
    unsigned long long w;
    uint32_t st;
    do {
      // Below tile 0 counts as an inclusive prefix of 0.
      w = at >= 0 ? load_word(state + at) : word(epoch, kInclusive, T(0));
      const uint32_t tag = (uint32_t)(w >> 32);
      st = (tag >> 2) == epoch ? tag & 3 : 0;
    } while (__any_sync(0xffffffffu, st == 0));
    const uint32_t inclusive = __ballot_sync(0xffffffffu, st == kInclusive);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    prefix += warp_sum(lane <= stop ? from_bits<T>((uint32_t)w) : T(0));
    if (inclusive) return prefix;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ in, T* __restrict__ out,
            unsigned long long* __restrict__ state, long long n,
            uint32_t epoch) {
  __shared__ T warp_totals[32];
  __shared__ T tile_prefix;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = (long long)tile * kTile + threadIdx.x * kItems;

  // 1. This thread's 8 elements, scanned in registers.
  T v[kItems];
  const bool whole = first + kItems <= n &&
                     ((uintptr_t)(in + first) & 15) == 0 &&
                     ((uintptr_t)(out + first) & 15) == 0;
  if (whole) {
    const uint4* src = reinterpret_cast<const uint4*>(in + first);
    const uint4 a = __ldg(src), b = __ldg(src + 1);
    const uint32_t bits[kItems] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = from_bits<T>(bits[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      v[j] = first + j < n ? in[first + j] : T(0);
  }
#pragma unroll
  for (int j = 1; j < kItems; ++j) v[j] += v[j - 1];

  // The threads' totals: an exclusive scan over the CTA.
  const T incl = warp_inclusive_scan(v[kItems - 1]);
  T before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = T(0);
  if (lane == 31) warp_totals[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T total = warp_inclusive_scan(warp_totals[lane]);
    warp_totals[lane] = total;  // kThreads / 32 == 32 warps
    // 2. Publish the tile's total, then its inclusive prefix.
    const T aggregate = __shfl_sync(0xffffffffu, total, 31);
    if (tile == 0) {
      if (lane == 0) {
        store_word(state, word(epoch, kInclusive, aggregate));
        tile_prefix = T(0);
      }
    } else {
      if (lane == 0)
        store_word(state + tile, word(epoch, kAggregate, aggregate));
      const T prefix = look_back<T>(state, tile, epoch);
      if (lane == 0) {
        store_word(state + tile, word(epoch, kInclusive, prefix + aggregate));
        tile_prefix = prefix;
      }
    }
  }
  __syncthreads();

  // 3. Add everything before this thread and store.
  before += tile_prefix;
  if (warp > 0) before += warp_totals[warp - 1];
#pragma unroll
  for (int j = 0; j < kItems; ++j) v[j] += before;
  if (whole) {
    uint4* dst = reinterpret_cast<uint4*>(out + first);
    dst[0] = make_uint4(to_bits(v[0]), to_bits(v[1]), to_bits(v[2]),
                        to_bits(v[3]));
    dst[1] = make_uint4(to_bits(v[4]), to_bits(v[5]), to_bits(v[6]),
                        to_bits(v[7]));
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (first + j < n) out[first + j] = v[j];
  }
}

template <typename T>
int cumsum(const void* in, void* out, void* state, long long n, int epoch,
           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (epoch < 1 || epoch >= (1 << 30) || n_tiles > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  scan_kernel<T><<<(unsigned)n_tiles, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out),
      static_cast<unsigned long long*>(state), n, (uint32_t)epoch);
  return (int)cudaGetLastError();
}

}  // namespace

// `state` holds ceil(n / 8192) 64-bit status words; `epoch` (1 to
// 2^30 - 1) differs from that of every word already there.
extern "C" int spf_cumsum_i32(const void* in, void* out, void* state,
                              long long n, int epoch, void* stream) {
  return cumsum<uint32_t>(in, out, state, n, epoch, stream);
}

extern "C" int spf_cumsum_f32(const void* in, void* out, void* state,
                              long long n, int epoch, void* stream) {
  return cumsum<float>(in, out, state, n, epoch, stream);
}
