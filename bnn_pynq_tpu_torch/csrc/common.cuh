// Shared constants and helpers of the port's kernels.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace bnn {

constexpr int kThreads = 256;               // threads per block, every kernel
constexpr int kVec = 16;                    // bytes per vector load
constexpr int kMaxThr = 15;                 // thresholds per channel (abits <= 4)
constexpr int kDefaultSmem = 48 * 1024;     // above this: opt in per kernel
constexpr int kMaxSmem = 227 * 1024;        // H100: 232,448 bytes a block
constexpr int kSmemPerSm = 228 * 1024;      // H100: what an SM's blocks share,
constexpr int kReservedSmem = 1024;         // ... each with this much more

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// A bipolar activation code c stands for the level 2c − off: 2c − 1
// (abits 1), 2c − 3 (abits 2). Unsigned codes (MobileNet's 4-bit ones,
// ResNet's 2-bit ones: a QuantReLU's output, level = code) are their own
// levels; which a network's codes are is its config's to say, so the
// launchers take them as levels where the caller says so (input_levels).
inline bool abits_ok(int abits) {
  return abits == 1 || abits == 2 || abits == 4;
}
inline int level_off(int abits) { return abits == 1 ? 1 : abits == 2 ? 3 : 0; }

// The threshold counts the epilogues are built for: 1-3 (abits <= 2) and 15.
inline bool nthr_ok(int nthr) {
  return (nthr >= 1 && nthr <= 3) || nthr == kMaxThr;
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
