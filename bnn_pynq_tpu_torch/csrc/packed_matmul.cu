// Quantized matmul on bit-packed operands, with a fused MultiThreshold.
//
// Replaces bnn_pynq_tpu/ops/matmul.py::packed_matmul, the TPU kernel of
// every binary and 2-bit conv and dense layer on the packed routes, and its
// three arms: _vpu_kernel (XNOR-popcount), _mxu_t_kernel and _mxu_kernel
// (decode to int8 levels, then an int8 dot; the two differ only in the
// TPU's lane layout, so one arm here serves both). Entry: bnn_packed_matmul.
//
//   a    uint32 [m, kw]  packed along K (bit j of word w = element 32w+j;
//                        2-bit code j at bits [2j, 2j+2)); pad bits are 0
//   w    uint32 [kw, n]  packed along K the same way
//   thr  int32 [nthr, n] ascending, or null
//   out  int8 codes sum_t (acc >= thr[t]) [m, n], or int32 acc [m, n]
//
//   popcount arm (bits = 1):  acc = k - 2 * sum popc(a XOR w); the pad bits
//                             agree, so they drop out
//   decode arm (bits = 1, 2): acc = sum level(a) * level(w) - n_pad * padval^2,
//                             levels 2b-1 or 2c-3, a pad position adds
//                             (-1)^2 = 1 or (-3)^2 = 9
//
// The decode is in natural order: staged int q of a word holds elements
// 4q..4q+3 as four int8 levels, the same in both operands, which is all
// __dp4a needs. (The TPU kernel's bit-plane order is a permutation of K
// that suits its lanes; it is not carried over.)
//
// One block owns a 64 x 64 output tile; each of its 256 threads a 4 x 4
// register tile (rows ty + 16i, columns tx + 16j). K goes through shared
// memory in rounds of 64 ints per row: raw words for the popcount arm,
// decoded levels (8 ints per word for bits = 1, 4 for bits = 2) for the
// decode arm. The weight tile is stored transposed, [column][K], so both
// operands are read as 16-byte vectors along K. Rows past m and columns
// past n are computed on zero words and never stored, so any m and n work.
//
// What bounds it on the H100: integer issue, not memory. At CNV's conv1
// (batch 1024: m = 802,816, K = 576, n = 64) the popcount arm issues
// ~1.0 G popc and the decode arm ~7.4 G dp4a, on the CUDA cores. The
// operands are small (a: 58 MB of words at bits = 1) and every block reuses
// each staged vector across 4 rows or columns from registers. Moving the
// popcount arm to mma.sync .b1 (XOR/AND + popc on the tensor cores) and the
// decode arm to int8 wgmma with TMA-staged tiles is later work.
#include "common.cuh"

namespace bnn {
namespace {

constexpr int kTile = 64;               // output rows and columns of a block
constexpr int kSub = 4;                 // rows and columns of a thread
constexpr int kLanes = kTile / kSub;    // 16 threads along each tile side
constexpr int kChunk = 64;              // staged ints of K per row and round
// Shared row stride in ints: 272 bytes, an odd multiple of 16, so the 16-byte
// loads of 8 neighbouring rows fall in distinct banks.
constexpr int kStride = kChunk + 4;
static_assert(kLanes * kLanes == kThreads, "one thread per 4 x 4 sub-tile");

struct Args {
  const uint32_t* a;
  const uint32_t* w;
  const int32_t* thr;
  int m, kw, n, k, nthr, pad_term;
  int8_t* codes;                        // when thr is set
  int32_t* acc;                         // otherwise
};

// Four 1-bit fields (bits 0..3 of x) → four int8 levels 2b-1, byte i = bit i.
__device__ __forceinline__ uint32_t levels1(uint32_t x) {
  const uint32_t s =
      (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
  return __vsub4(s << 1, 0x01010101u);
}

// Four 2-bit codes (bits 0..7 of x) → four int8 levels 2c-3, byte i = code i.
__device__ __forceinline__ uint32_t levels2(uint32_t x) {
  const uint32_t s = (x & 0x3u) | ((x & 0xCu) << 6) | ((x & 0x30u) << 12) |
                     ((x & 0xC0u) << 18);
  return __vsub4(s << 1, 0x03030303u);
}

template <int BITS, bool POPC>
__device__ __forceinline__ void stage_word(uint32_t word, uint32_t* dst) {
  if constexpr (POPC) {
    dst[0] = word;
  } else if constexpr (BITS == 1) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(levels1(word), levels1(word >> 4), levels1(word >> 8),
                      levels1(word >> 12));
    d[1] = make_uint4(levels1(word >> 16), levels1(word >> 20),
                      levels1(word >> 24), levels1(word >> 28));
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        levels2(word), levels2(word >> 8), levels2(word >> 16),
        levels2(word >> 24));
  }
}

template <int BITS, bool POPC>
__global__ void __launch_bounds__(kThreads)
packed_matmul_kernel(const Args p) {
  // staged ints per packed word: the word itself, or its decoded levels
  constexpr int kIpw = POPC ? 1 : (BITS == 1 ? 8 : 4);
  constexpr int kWords = kChunk / kIpw;   // packed words per round
  __shared__ __align__(16) uint32_t sa[kTile * kStride];
  __shared__ __align__(16) uint32_t sw[kTile * kStride];
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;

  int acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0;
  }

  for (int kw0 = 0; kw0 < p.kw; kw0 += kWords) {
    const int cw = min(kWords, p.kw - kw0);
    const int ints = cw * kIpw;
    const int ints4 = (ints + 3) & ~3;    // > ints only for the popcount arm
    for (int idx = threadIdx.x; idx < kTile * cw; idx += kThreads) {
      const int r = idx / cw;
      const int c = idx % cw;
      const uint32_t word =
          m0 + r < p.m
              ? __ldg(p.a + static_cast<size_t>(m0 + r) * p.kw + kw0 + c)
              : 0u;
      stage_word<BITS, POPC>(word, sa + r * kStride + c * kIpw);
    }
    for (int idx = threadIdx.x; idx < kTile * cw; idx += kThreads) {
      const int c = idx / kTile;
      const int col = idx % kTile;
      const uint32_t word =
          n0 + col < p.n
              ? __ldg(p.w + static_cast<size_t>(kw0 + c) * p.n + n0 + col)
              : 0u;
      stage_word<BITS, POPC>(word, sw + col * kStride + c * kIpw);
    }
    // zero words past K up to the next 16-byte vector: XOR to 0
    const int tail = ints4 - ints;
    for (int idx = threadIdx.x; idx < kTile * tail; idx += kThreads) {
      const int r = idx / tail;
      const int c = ints + idx % tail;
      sa[r * kStride + c] = 0u;
      sw[r * kStride + c] = 0u;
    }
    __syncthreads();

    for (int kk = 0; kk < ints4; kk += 4) {
      uint4 av[kSub], wv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        av[i] = *reinterpret_cast<const uint4*>(
            sa + (ty + i * kLanes) * kStride + kk);
        wv[i] = *reinterpret_cast<const uint4*>(
            sw + (tx + i * kLanes) * kStride + kk);
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          if constexpr (POPC) {
            acc[i][j] += __popc(av[i].x ^ wv[j].x) + __popc(av[i].y ^ wv[j].y) +
                         __popc(av[i].z ^ wv[j].z) + __popc(av[i].w ^ wv[j].w);
          } else {
            int s = acc[i][j];
            s = __dp4a(static_cast<int>(av[i].x), static_cast<int>(wv[j].x), s);
            s = __dp4a(static_cast<int>(av[i].y), static_cast<int>(wv[j].y), s);
            s = __dp4a(static_cast<int>(av[i].z), static_cast<int>(wv[j].z), s);
            s = __dp4a(static_cast<int>(av[i].w), static_cast<int>(wv[j].w), s);
            acc[i][j] = s;
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: true accumulator, then MultiThreshold (or int32 out)
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const int col = n0 + tx + j * kLanes;
    if (col >= p.n) continue;
    int th[kMaxThr];
#pragma unroll
    for (int t = 0; t < kMaxThr; ++t) {
      th[t] = (p.thr != nullptr && t < p.nthr) ? __ldg(p.thr + t * p.n + col)
                                               : 0;
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int row = m0 + ty + i * kLanes;
      if (row >= p.m) continue;
      const int v = POPC ? p.k - 2 * acc[i][j] : acc[i][j] - p.pad_term;
      const size_t o = static_cast<size_t>(row) * p.n + col;
      if (p.thr != nullptr) {
        int code = 0;
#pragma unroll
        for (int t = 0; t < kMaxThr; ++t) code += (t < p.nthr && v >= th[t]);
        p.codes[o] = static_cast<int8_t>(code);
      } else {
        p.acc[o] = v;
      }
    }
  }
}

}  // namespace
}  // namespace bnn

extern "C" {

// a [m, kw], w [kw, n] uint32 words packed along K (true length k, width
// bits); popc = 1 selects XNOR-popcount (bits = 1 only), 0 the decode arm.
// thr int32 [nthr, n] → out int8 codes; thr null (nthr 0) → out int32 acc.
int bnn_packed_matmul(const void* a, int m, int kw, const void* w, int n,
                      int k, int bits, int popc, const void* thr, int nthr,
                      void* out, void* stream) {
  using namespace bnn;
  const int per_word = 32 / (bits == 1 || bits == 2 ? bits : 1);
  if ((bits != 1 && bits != 2) || (popc && bits != 1) || m < 0 || n < 1 ||
      k < 1 || kw != (k + per_word - 1) / per_word ||
      (thr == nullptr) != (nthr == 0) || nthr < 0 || nthr > kMaxThr) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;
  const int padval = bits == 1 ? 1 : 3;
  Args p = {};
  p.a = static_cast<const uint32_t*>(a);
  p.w = static_cast<const uint32_t*>(w);
  p.thr = static_cast<const int32_t*>(thr);
  p.m = m;
  p.kw = kw;
  p.n = n;
  p.k = k;
  p.nthr = nthr;
  p.pad_term = (kw * per_word - k) * padval * padval;
  p.codes = thr != nullptr ? static_cast<int8_t*>(out) : nullptr;
  p.acc = thr != nullptr ? nullptr : static_cast<int32_t*>(out);

  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (popc) {
    packed_matmul_kernel<1, true><<<grid, kThreads, 0, s>>>(p);
  } else if (bits == 1) {
    packed_matmul_kernel<1, false><<<grid, kThreads, 0, s>>>(p);
  } else {
    packed_matmul_kernel<2, false><<<grid, kThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

}  // extern "C"
