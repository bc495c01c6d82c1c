// The dynamic shared-memory limit of a kernel, shared by the port's
// kernels that take more than 48 KB (K1, K2 and K5).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kernel_launch {

// Dynamic shared memory above 48 KB needs the kernel's limit raised, once
// on each device: `raised` is the caller's record, one bit a device.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, uint64_t& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (raised & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) raised |= bit;
  return err;
}

}  // namespace kernel_launch
