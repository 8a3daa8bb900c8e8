// MobileNet's depthwise 3×3 conv with the MultiThreshold fused: NHWC int8
// unsigned 4-bit codes (0..15, their own levels) in, one 3×3 filter per
// channel, stride 1 or 2, SAME zero padding (pad 1), an exact int32 sum,
// 15 thresholds a channel, int8 codes [B, OH, OW, C] out. The wrapper is
// ops/depthwise.py::depthwise_conv.
//
// Replaces no TPU kernel: the JAX package runs no depthwise conv. It was
// added for MobileNet-v1 W4A4 (models/config.py::mobilenet_v1), whose 13
// depthwise layers are 3.1 % of its MACs but move ~5.0 MB of codes an image.
//
// What bounds it on the H100: bytes. At batch 256 the 13 layers read and
// write 1.28 GB of codes (0.38 ms at 3.35 TB/s) against 8.9 G operations
// (0.005 ms at the int8 peak). But no tensor core applies, and the work per
// output byte on the CUDA cores, 9 products and 15 compares, is what sets
// its pace. What the design does about it:
// - a thread owns 4 neighbouring channels (one 4-byte word of a pixel) and
//   keeps their weights and 15 × 4 thresholds in registers, loaded once:
//   the block is 256 threads and 256 is a multiple of C/4, so a thread's
//   channels never change while it walks its pixels;
// - a block walks output rows (persistent grid); a thread takes two pixels
//   of a row at a time and issues all 18 tap loads before any arithmetic
//   (a tap in the padding loads nothing and reads 0): consecutive threads
//   read consecutive words of one input pixel and then of the next, so a
//   load is coalesced, and the taps neighbouring pixels share come from L1;
// - one dp4a a channel and kernel row: two byte permutes gather that
//   channel's three taps of the row into one word, against a weight word
//   gathered the same way once (the code bytes are 0..15, so reading them
//   signed is exact);
// - the count of passed thresholds is summed into a byte a channel and the
//   4 codes leave as one 4-byte store.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, batch 256, MobileNet's 13
// layers): 1.79 ms, against 4.06 ms for a first version that loaded each tap
// behind its own bounds test and took one dp4a a tap and channel (PERF.md
// §6; bound 0.38 ms).
#include "common.cuh"

namespace bnn {
namespace {

constexpr int kDwPix = 2;             // pixels a thread takes at a time

struct DwArgs {
  const int8_t* x;      // [b, h, w, c] codes
  const int8_t* wt;     // [9, c] weight levels, tap (ki, kj) major
  const int32_t* thr;   // [kMaxThr, c]
  int8_t* out;          // [b, oh, ow, c] codes
  int h, w, c, oh, ow, stride;
  int rows;             // b · oh output rows
};

// Byte k of the words a, b, c as bytes 0, 1, 2 of one word (byte 3: junk,
// which a weight word with byte 3 zero ignores).
__device__ __forceinline__ int gather3(int a, int b, int c, int k) {
  const int ab = __byte_perm(a, b, k | ((k + 4) << 4));
  return __byte_perm(ab, c, 0x4010 | ((k + 4) << 8));
}

__global__ void __launch_bounds__(kThreads, 2) dw_kernel(const DwArgs a) {
  const int cq = a.c >> 2;                    // channel words a pixel
  const int q = threadIdx.x % cq;             // this thread's word
  const int px0 = threadIdx.x / cq;
  const int pstep = blockDim.x / cq;
  // per kernel row ki and channel byte k: [w(ki,0), w(ki,1), w(ki,2), 0]
  int wr[3][4];
#pragma unroll
  for (int ki = 0; ki < 3; ++ki) {
    int wk[3];
#pragma unroll
    for (int kj = 0; kj < 3; ++kj) {
      wk[kj] = __ldg(reinterpret_cast<const int*>(a.wt + (3 * ki + kj) * a.c) +
                     q);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wr[ki][k] = gather3(wk[0], wk[1], wk[2], k) & 0x00ffffff;
    }
  }
  int4 th[kMaxThr];
#pragma unroll
  for (int t = 0; t < kMaxThr; ++t) {
    th[t] = __ldg(reinterpret_cast<const int4*>(a.thr + t * a.c) + q);
  }
  for (int r = blockIdx.x; r < a.rows; r += gridDim.x) {
    const int n = r / a.oh;
    const int oy = r - n * a.oh;
    const int iy0 = oy * a.stride - 1;
    const int8_t* img = a.x + static_cast<size_t>(n) * a.h * a.w * a.c;
    int* const orow = reinterpret_cast<int*>(
        a.out + static_cast<size_t>(r) * a.ow * a.c);
    for (int ox0 = px0; ox0 < a.ow; ox0 += kDwPix * pstep) {
      int xv[kDwPix][3][3];
#pragma unroll
      for (int p = 0; p < kDwPix; ++p) {
        const int ox = ox0 + p * pstep;
        const int ix0 = ox * a.stride - 1;
#pragma unroll
        for (int ki = 0; ki < 3; ++ki) {
          const int iy = iy0 + ki;
          const bool row_in = iy >= 0 && iy < a.h && ox < a.ow;
          const int* row = reinterpret_cast<const int*>(
                               img + static_cast<size_t>(iy) * a.w * a.c) + q;
#pragma unroll
          for (int kj = 0; kj < 3; ++kj) {
            const int ix = ix0 + kj;
            xv[p][ki][kj] =
                row_in && ix >= 0 && ix < a.w ? __ldg(row + ix * cq) : 0;
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kDwPix; ++p) {
        const int ox = ox0 + p * pstep;
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int ki = 0; ki < 3; ++ki) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[k] = __dp4a(gather3(xv[p][ki][0], xv[p][ki][1], xv[p][ki][2],
                                    k),
                            wr[ki][k], acc[k]);
          }
        }
        int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
        for (int t = 0; t < kMaxThr; ++t) {
          c0 += acc[0] >= th[t].x;
          c1 += acc[1] >= th[t].y;
          c2 += acc[2] >= th[t].z;
          c3 += acc[3] >= th[t].w;
        }
        if (ox < a.ow) {
          orow[ox * cq + q] = c0 | (c1 << 8) | (c2 << 16) | (c3 << 24);
        }
      }
    }
  }
}

}  // namespace
}  // namespace bnn

extern "C" {

// x: int8 [b, h, w, c] unsigned 4-bit codes (0..15); wt: int8 [9, c] levels;
// thr: int32 [nthr, c]; out: int8 [b, (h-1)/stride+1, (w-1)/stride+1, c]
// codes. Takes abits 4, nthr 15, stride 1 or 2, c a multiple of 4 whose c/4
// divides 256, and 16-byte-aligned operands.
int bnn_dw_conv(const void* x, int b, int h, int w, int c, int stride,
                const void* wt, const void* thr, int nthr, int abits,
                void* out, void* stream) {
  using namespace bnn;
  if (b < 0 || h < 1 || w < 1 || c < 4 || c % 4 != 0 ||
      kThreads % (c / 4) != 0 || (stride != 1 && stride != 2) ||
      abits != 4 || nthr != kMaxThr) {
    return cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt) |
       reinterpret_cast<uintptr_t>(thr) | reinterpret_cast<uintptr_t>(out)) %
          kVec != 0) {
    return cudaErrorInvalidValue;
  }
  DwArgs a = {};
  a.x = static_cast<const int8_t*>(x);
  a.wt = static_cast<const int8_t*>(wt);
  a.thr = static_cast<const int32_t*>(thr);
  a.out = static_cast<int8_t*>(out);
  a.h = h;
  a.w = w;
  a.c = c;
  a.stride = stride;
  a.oh = (h - 1) / stride + 1;
  a.ow = (w - 1) / stride + 1;
  const long long rows = static_cast<long long>(b) * a.oh;
  if (rows * a.ow * c > 0x7fffffffLL ||
      static_cast<long long>(b) * h * w * c > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (rows == 0) return cudaSuccess;
  a.rows = static_cast<int>(rows);

  cudaError_t err;
  int device = 0, sms = 0, resident = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &resident, dw_kernel, kThreads, 0)) != cudaSuccess) {
    return err;
  }
  if (resident < 1) return cudaErrorInvalidValue;
  const long long room = static_cast<long long>(sms) * resident;
  const int grid = static_cast<int>(rows < room ? rows : room);
  dw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
