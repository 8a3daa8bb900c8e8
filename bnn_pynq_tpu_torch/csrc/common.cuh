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

// An activation code c stands for the level mul·c − off: 2c − 1 (abits 1),
// 2c − 3 (abits 2), and c itself for MobileNet's unsigned 4-bit codes
// (abits 4), which the kernels therefore read as levels.
inline bool abits_ok(int abits) {
  return abits == 1 || abits == 2 || abits == 4;
}
inline int level_off(int abits) { return abits == 1 ? 1 : abits == 2 ? 3 : 0; }
inline bool codes_are_levels(int abits) { return abits == 4; }

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
