// Shared constants and helpers of the port's kernels.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace bnn {

constexpr int kThreads = 256;               // threads per block, every kernel
constexpr int kVec = 16;                    // bytes per vector load
constexpr int kMaxThr = 3;                  // thresholds per channel (abits <= 2)
constexpr int kDefaultSmem = 48 * 1024;     // above this: opt in per kernel
constexpr int kMaxSmem = 227 * 1024;        // H100: 232,448 bytes a block

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Four code bytes {0..3} → levels 2c - off, byte-wise (2c <= 6: no carry).
__device__ __forceinline__ unsigned codes_to_levels4(unsigned u, int off) {
  return __vsub4(u + u, 0x01010101u * static_cast<unsigned>(off));
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace bnn
