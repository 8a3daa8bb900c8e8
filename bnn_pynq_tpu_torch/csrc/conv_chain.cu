// One stride-1 VALID K×K quantized conv with the MultiThreshold fused:
// NHWC int8 codes (or raw int8 levels) in, int8 codes of the valid region
// [B, H-K+1, W-K+1, N] out. The wrapper (ops/conv_stack.py::conv_chain)
// launches it once per layer of a chain.
//
// Replaces bnn_pynq_tpu/ops/conv_stack.py::conv_chain_vmem (CNV's
// conv1+conv2 and conv3+conv4 chains). The JAX kernel returns the full
// pitch grid with garbage borders and needs the first conv's patches built
// outside it (im2col0); this kernel writes only the valid region and reads
// the raw 3-channel image itself, so that glue stage is gone.
//
// Implicit GEMM: a block owns kConvRows output pixels. It gathers their
// K·K·C patches, in (ki, kj, c) order, from device memory into shared memory
// as int8 levels (16-byte vectors when C % 16 == 0, codes → levels with
// byte-wise SIMD; byte by byte otherwise, as for the 3-channel image), then
// runs layer_tile (dense_tile.cuh): one thread per (output channel, 8
// pixels), int32 dots by __dp4a over the padded patch row, threshold to
// codes. Because the patch row is contiguous, dp4a applies for every C,
// including C = 3.
//
// What bounds it on the H100: dp4a issue on the CUDA cores (conv2 of CNV is
// 29.6 G MACs at batch 1024) and the 9× re-read of each input pixel by
// neighbouring patches, which L1/L2 absorb. Keeping a chain's intermediate
// codes on chip, reusing pixels across taps from a shared-memory halo
// tile, and int8 mma/wgmma are later work.
#include "dense_tile.cuh"

namespace bnn {
namespace {

constexpr int kConvRows = 32;   // output pixels per block
constexpr int kConvRpt = 8;     // pixels a thread computes per weight load

struct ConvArgs {
  const int8_t* x;     // [b, h, w, c]
  int h, w, c;
  int ksize;
  int input_levels;
  int level_off;
  const int8_t* wt;    // [n_out, kp] levels, (ki, kj, c) order, zero past K
  int kp;
  int n_out;
  const int32_t* thr;  // [nthr, n_out]
  int nthr;
  int8_t* out;         // [b, oh, ow, n_out] codes
  int oh, ow;
  int pixels;          // b * oh * ow
};

__global__ void __launch_bounds__(kThreads) conv_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) int8_t patches[];  // [kConvRows, kp]
  __shared__ size_t row_base[kConvRows];             // x offset of (oy, ox)
  const int p0 = blockIdx.x * kConvRows;
  const int rows = min(kConvRows, a.pixels - p0);

  if (threadIdx.x < rows) {
    const int p = p0 + threadIdx.x;
    const int ox = p % a.ow;
    const int t = p / a.ow;
    const int oy = t % a.oh;
    const int bi = t / a.oh;
    row_base[threadIdx.x] =
        ((static_cast<size_t>(bi) * a.h + oy) * a.w + ox) * a.c;
  }
  __syncthreads();

  const int taps = a.ksize * a.ksize;
  if (a.c % kVec == 0) {
    const int cv = a.c / kVec;
    const int per_row = taps * cv;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int rem = i - r * per_row;
      const int tap = rem / cv;
      const int v = rem - tap * cv;
      const int ki = tap / a.ksize;
      const int kj = tap - ki * a.ksize;
      const int8_t* src = a.x + row_base[r] +
                          (static_cast<size_t>(ki) * a.w + kj) * a.c +
                          v * kVec;
      int4 val = __ldg(reinterpret_cast<const int4*>(src));
      if (!a.input_levels) {
        val.x = codes_to_levels4(val.x, a.level_off);
        val.y = codes_to_levels4(val.y, a.level_off);
        val.z = codes_to_levels4(val.z, a.level_off);
        val.w = codes_to_levels4(val.w, a.level_off);
      }
      *reinterpret_cast<int4*>(patches + r * a.kp + rem * kVec) = val;
    }
  } else {
    const int per_row = taps * a.c;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int rem = i - r * per_row;
      const int tap = rem / a.c;
      const int ch = rem - tap * a.c;
      const int ki = tap / a.ksize;
      const int kj = tap - ki * a.ksize;
      const int8_t v = __ldg(a.x + row_base[r] +
                             (static_cast<size_t>(ki) * a.w + kj) * a.c + ch);
      patches[r * a.kp + rem] =
          a.input_levels ? v : static_cast<int8_t>(2 * v - a.level_off);
    }
  }
  __syncthreads();

  TileOut o = {};
  o.mode = kCodesToGlobal;
  o.codes = a.out + static_cast<size_t>(p0) * a.n_out;
  layer_tile<kConvRows, kConvRpt>(patches, a.kp, rows, a.wt, a.kp, a.n_out,
                                  a.thr, a.nthr, a.level_off, o);
}

}  // namespace
}  // namespace bnn

extern "C" {

// x: int8 [b, h, w, c] codes (levels if input_levels); wt: int8 [n_out, kp]
// with kp = round_up(ksize²·c, 16); thr: int32 [nthr, n_out];
// out: int8 [b, h-ksize+1, w-ksize+1, n_out].
int bnn_conv_layer(const void* x, int b, int h, int w, int c, int ksize,
                   int input_levels, const void* wt, int kp, int n_out,
                   const void* thr, int nthr, int abits, void* out,
                   void* stream) {
  using namespace bnn;
  if (b < 0 || c < 1 || ksize < 1 || h < ksize || w < ksize || n_out < 1 ||
      nthr < 1 || nthr > kMaxThr || (abits != 1 && abits != 2) ||
      kp != round_up(ksize * ksize * c, kVec)) {
    return cudaErrorInvalidValue;
  }
  const int oh = h - ksize + 1;
  const int ow = w - ksize + 1;
  const long long pixels = static_cast<long long>(b) * oh * ow;
  if (pixels > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (pixels == 0) return cudaSuccess;

  ConvArgs a = {};
  a.x = static_cast<const int8_t*>(x);
  a.h = h;
  a.w = w;
  a.c = c;
  a.ksize = ksize;
  a.input_levels = input_levels;
  a.level_off = abits == 1 ? 1 : 3;
  a.wt = static_cast<const int8_t*>(wt);
  a.kp = kp;
  a.n_out = n_out;
  a.thr = static_cast<const int32_t*>(thr);
  a.nthr = nthr;
  a.out = static_cast<int8_t*>(out);
  a.oh = oh;
  a.ow = ow;
  a.pixels = static_cast<int>(pixels);

  const size_t smem = static_cast<size_t>(kConvRows) * kp;
  cudaError_t err = allow_smem(conv_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = static_cast<int>((pixels + kConvRows - 1) / kConvRows);
  conv_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return cudaGetLastError();
}

}  // extern "C"
