// Shared constants and helpers of the port's kernels, and the dp4a body of
// the whole-MLP kernel (dense_chain.cu): one quantized layer for a tile of
// rows whose int8 levels sit in shared memory. Each thread owns one output
// column n and RPT rows: it streams weight row n (K contiguous, 16 bytes at
// a time) once and reuses each 16-byte vector for its RPT rows, accumulating
// exact int32 dots with __dp4a. The epilogue is the MultiThreshold
// (<= 3 int32 compares) or, on a network's last layer, the float scale/bias.
//
// Layout contract (checked by the Python wrappers):
//   activations  int8 levels [rows, stride] in shared memory, stride % 16 == 0
//   weights      int8 levels [N, Kp] in device memory, Kp = K rounded up to
//                16, zero past K; a zero level adds nothing to the dot, so the
//                garbage shared-memory bytes between K and Kp never matter
//   thresholds   int32 [nthr, N], ascending along nthr, 1 <= nthr <= 3
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

enum Epilogue : int {
  kLevelsToShared = 0,   // threshold → next layer's levels, in shared memory
  kLogitsToGlobal = 1,   // float(acc) * scale + bias → float32, device memory
};

struct TileOut {
  int mode;
  int8_t* next;          // kLevelsToShared: [tile rows, next_stride]
  int next_stride;
  float* logits;         // kLogitsToGlobal: [rows, n_out], from the tile's row 0
  const float* scale;    // kLogitsToGlobal: [n_out]
  const float* bias;     // kLogitsToGlobal: [n_out]
};

// One layer for a tile of TM rows, of which the first `rows` are real (the
// rest are the ragged edge of the batch: computed, never stored to device
// memory).
template <int TM, int RPT>
__device__ __forceinline__ void layer_tile(
    const int8_t* __restrict__ act, int act_stride, int rows,
    const int8_t* __restrict__ w, int kp, int n_out,
    const int32_t* __restrict__ thr, int nthr, int level_off,
    const TileOut& o) {
  static_assert(TM % RPT == 0, "a thread owns RPT whole rows of the tile");
  constexpr int kChunks = TM / RPT;
  for (int item = threadIdx.x; item < kChunks * n_out; item += blockDim.x) {
    const int n = item % n_out;
    const int r0 = (item / n_out) * RPT;
    const int8_t* wn = w + static_cast<size_t>(n) * kp;
    const int8_t* a0 = act + r0 * act_stride;

    int acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0;
    for (int k = 0; k < kp; k += kVec) {
      const int4 wv = __ldg(reinterpret_cast<const int4*>(wn + k));
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int4 av =
            *reinterpret_cast<const int4*>(a0 + r * act_stride + k);
        acc[r] = __dp4a(av.x, wv.x, acc[r]);
        acc[r] = __dp4a(av.y, wv.y, acc[r]);
        acc[r] = __dp4a(av.z, wv.z, acc[r]);
        acc[r] = __dp4a(av.w, wv.w, acc[r]);
      }
    }

    if (o.mode == kLogitsToGlobal) {
      // JAX computes acc.astype(f32) * scale + bias as a separate multiply
      // and add; the _rn intrinsics keep nvcc from contracting them to an
      // FMA. |acc| < 2^24, so the conversion is exact.
      const float s = __ldg(o.scale + n);
      const float b = __ldg(o.bias + n);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        if (r0 + r < rows) {
          o.logits[static_cast<size_t>(r0 + r) * n_out + n] =
              __fadd_rn(__fmul_rn(__int2float_rn(acc[r]), s), b);
        }
      }
      continue;
    }

    int th[kMaxThr];
#pragma unroll
    for (int t = 0; t < kMaxThr; ++t) {
      th[t] = t < nthr ? __ldg(thr + t * n_out + n) : 0;
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      int code = 0;
#pragma unroll
      for (int t = 0; t < kMaxThr; ++t) {
        code += (t < nthr && acc[r] >= th[t]) ? 1 : 0;
      }
      o.next[(r0 + r) * o.next_stride + n] =
          static_cast<int8_t>(2 * code - level_off);
    }
  }
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
