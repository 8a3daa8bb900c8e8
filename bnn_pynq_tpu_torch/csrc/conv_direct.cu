// Direct (no-im2col) quantized convs: one stride-1 VALID K×K layer (entry
// bnn_conv_direct), or several chained layers whose intermediate levels
// never leave shared memory (entry bnn_conv_chain_direct).
//
// Replaces bnn_pynq_tpu/ops/conv_direct.py::conv2d_direct and
// ::conv_chain_direct. The TPU kernels sum K² shifted MXU dots over a
// flattened "pitch grid", computing garbage rows at the borders that the
// caller slices away, and pad the batch to their block; these kernels compute
// only the valid output pixels and take any batch.
//
// bnn_conv_direct (the `direct` route: 5 launches per CNV forward) runs on
// the int8 tensor cores. It is conv_tile.cuh's persistent implicit GEMM, the
// kernel of conv_chain.cu::bnn_conv_layer: the layer's weights staged once
// per block in shared memory, the input rows of a tile of consecutive
// output pixels copied once as raw codes by cp.async, the taps read at
// shifted offsets by ldmatrix, mma.sync m16n8k32, the thresholds folded
// onto the raw accumulator. What bounds it is operations (59 G MACs per
// forward at batch 1024: 0.063 ms at the card's 1,979 TOP/s, against 47 MB
// in and out); conv_chain.cu tells the design. Two things are this entry's:
// - without thresholds (a network's last layer) the epilogue stores the
//   true int32 accumulator, 2·acc − off·wsum for a dot on codes
//   (mma_tile.cuh::item_store_acc);
// - a conv whose kernel covers its whole input (CNV's conv5: 3×3 on a 3×3
//   map, K = 2304) is a dense layer on contiguous [B, K²C] rows, with no
//   gather at all and only B output pixels to tile: it goes to
//   dense_chain.cu's kernel as one thresholded layer (bnn_dense_codes: 32
//   rows a block, the weights streamed in tiles by bulk copy), which needs
//   no room for 590 KB of weights. (dense_block.cu's 64-row K-ring took
//   three times as long at batch 1024, the conv kernel here eighteen times:
//   three input rows per output pixel crowd the weights out of shared
//   memory.)
// The dp4a kernel this replaced (one thread per 8 pixels and one channel,
// weights streamed from L2 by every thread) took 2.48 ms per forward for
// the five layers on an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md §6 has
// the times of this one.
//
// bnn_conv_chain_direct (on no route, as in the JAX package) keeps that
// dp4a design, direct_kernel below. A block owns a tile: whole images where
// they fit in shared memory (several small ones, so a block has work), else
// a band of output rows of one image. It stages the tile's input rows plus
// the (K-1)-row halo of every chained layer, at full width, as int8 levels.
// Threads own (8 output pixels, output channel) pairs. For each tap a thread
// runs __dp4a over the shifted pixels' channels in shared memory against
// that tap's weights, streamed from L2 16 bytes (or 4, for C % 16 != 0) at a
// time and reused across the 8 pixels in registers. The epilogue thresholds
// to codes (next layer's levels, kept in the other half of a ping-pong pair
// of shared buffers, or int8 codes in device memory). At layer j of n a band
// recomputes the (n-1-j)(K-1) halo rows its later layers need; at every CNV
// shape whole images fit, so nothing is recomputed there. What bounds it:
// dp4a throughput on the CUDA cores and the weight stream from L2 (one
// 16-byte load per 8 pixels × 16 MACs).
#include <algorithm>

#include "conv_tile.cuh"

namespace bnn {
namespace {

constexpr int kDirectRpt = 8;           // output pixels a thread owns
constexpr int kDirectMaxLayers = 8;     // ops/fused_mlp.py MAX_LAYERS
constexpr int kTargetPixels = 32;       // below this many output pixels an
                                        // image shares its block
constexpr int kTileSmem = kMaxSmem / 2; // a tile's aim: two blocks per SM

// Channels of a pixel in shared memory: C rounded up to 4 with zero levels,
// so every tap's dot is whole dp4a words.
__host__ __device__ __forceinline__ int chan_pad(int c) {
  return (c + 3) / 4 * 4;
}

struct DirectLayer {
  const int8_t* w;       // [n_out, wstride] levels; tap t's channels at t*cp
  int wstride;
  int n_out;
  const int32_t* thr;    // [nthr, n_out]
};

struct DirectArgs {
  const int8_t* x;       // [b, h, w, c] codes, or levels if input_levels
  int b, h, w, c;
  int ksize;
  int input_levels;
  int level_off;
  int nthr;
  int n_layers;
  DirectLayer layer[kDirectMaxLayers];
  int8_t* out;           // [b, oh, ow, n_last] codes
  int oh, ow;            // the last layer's map
  int tile_imgs;         // images a block owns
  int tile_rows;         // final output rows a block owns (oh: whole images)
  int bands;             // ceil(oh / tile_rows)
  int region1;           // byte offset of the second ping-pong buffer
};

template <int VB> struct Dot;
template <> struct Dot<16> {
  using V = int4;
  static __device__ __forceinline__ int run(const V a, const V w, int acc) {
    acc = __dp4a(a.x, w.x, acc);
    acc = __dp4a(a.y, w.y, acc);
    acc = __dp4a(a.z, w.z, acc);
    return __dp4a(a.w, w.w, acc);
  }
};
template <> struct Dot<4> {
  using V = int;
  static __device__ __forceinline__ int run(const V a, const V w, int acc) {
    return __dp4a(a, w, acc);
  }
};

struct LayerOut {
  int8_t* next;          // levels [pixels, next_cp] in shared memory, or null
  int next_cp;
  int8_t* out;           // else device memory, from pixel out_base on
  size_t out_base;
  int img_pixels;        // pixels between two images in `out`
};

// One layer of the tile: input levels [imgs, hin, win, cp] in shared memory.
template <int VB>
__device__ __forceinline__ void direct_layer(
    const int8_t* __restrict__ in, int imgs, int hin, int win, int cp,
    int k, const DirectLayer& L, int nthr, int level_off, const LayerOut& o) {
  using V = typename Dot<VB>::V;
  const int hout = hin - k + 1;
  const int wout = win - k + 1;
  const int map = hout * wout;
  const int pixels = imgs * map;
  const int groups = (pixels + kDirectRpt - 1) / kDirectRpt;
  for (int item = threadIdx.x; item < groups * L.n_out; item += blockDim.x) {
    const int n = item % L.n_out;
    const int p0 = (item / L.n_out) * kDirectRpt;
    int base[kDirectRpt];       // shared-memory offset of each pixel's tap 0
    int acc[kDirectRpt];
#pragma unroll
    for (int r = 0; r < kDirectRpt; ++r) {
      const int p = min(p0 + r, pixels - 1);   // the ragged edge: recompute
      const int i = p / map;
      const int q = p - i * map;
      const int y = q / wout;
      base[r] = ((i * hin + y) * win + (q - y * wout)) * cp;
      acc[r] = 0;
    }
    const int8_t* wn = L.w + static_cast<size_t>(n) * L.wstride;
    for (int ki = 0; ki < k; ++ki) {
      for (int kj = 0; kj < k; ++kj) {
        const int8_t* wt = wn + (ki * k + kj) * cp;
        const int8_t* at = in + (ki * win + kj) * cp;
        for (int c = 0; c < cp; c += VB) {
          const V wv = __ldg(reinterpret_cast<const V*>(wt + c));
#pragma unroll
          for (int r = 0; r < kDirectRpt; ++r) {
            const V av = *reinterpret_cast<const V*>(at + base[r] + c);
            acc[r] = Dot<VB>::run(av, wv, acc[r]);
          }
        }
      }
    }

    int th[kMaxThr];
#pragma unroll
    for (int t = 0; t < kMaxThr; ++t) {
      th[t] = t < nthr ? __ldg(L.thr + t * L.n_out + n) : 0;
    }
#pragma unroll
    for (int r = 0; r < kDirectRpt; ++r) {
      const int p = p0 + r;
      if (p >= pixels) break;
      int code = 0;
#pragma unroll
      for (int t = 0; t < kMaxThr; ++t) {
        code += (t < nthr && acc[r] >= th[t]) ? 1 : 0;
      }
      if (o.next != nullptr) {
        o.next[p * o.next_cp + n] = static_cast<int8_t>(2 * code - level_off);
        continue;
      }
      const int i = p / map;
      const size_t idx =
          (o.out_base + static_cast<size_t>(i) * o.img_pixels + (p - i * map)) *
              L.n_out + n;
      o.out[idx] = static_cast<int8_t>(code);
    }
  }
}

// Copy rows [oy0, oy0 + rows) of images [img0, img0 + imgs) into shared
// memory as levels [imgs, rows, w, chan_pad(c)], the pad zero levels.
__device__ __forceinline__ void stage_input(const DirectArgs& a, int8_t* dst,
                                            int img0, int oy0, int imgs,
                                            int rows) {
  const int row_px = rows * a.w;
  const size_t img_px = static_cast<size_t>(a.h) * a.w;
  if (a.c % kVec == 0) {
    const int cv = a.c / kVec;
    for (int t = threadIdx.x; t < imgs * row_px * cv; t += blockDim.x) {
      const int q = t / cv;
      const int i = q / row_px;
      const size_t px = (img0 + i) * img_px +
                        static_cast<size_t>(oy0) * a.w + (q - i * row_px);
      int4 v = __ldg(reinterpret_cast<const int4*>(a.x + px * a.c) + t % cv);
      if (!a.input_levels) {
        v.x = codes_to_levels4(v.x, a.level_off);
        v.y = codes_to_levels4(v.y, a.level_off);
        v.z = codes_to_levels4(v.z, a.level_off);
        v.w = codes_to_levels4(v.w, a.level_off);
      }
      reinterpret_cast<int4*>(dst)[t] = v;
    }
    return;
  }
  const int cp = chan_pad(a.c);
  for (int t = threadIdx.x; t < imgs * row_px * cp; t += blockDim.x) {
    const int q = t / cp;
    const int ch = t - q * cp;
    int8_t v = 0;
    if (ch < a.c) {
      const int i = q / row_px;
      const size_t px = (img0 + i) * img_px +
                        static_cast<size_t>(oy0) * a.w + (q - i * row_px);
      v = __ldg(a.x + px * a.c + ch);
      if (!a.input_levels) v = static_cast<int8_t>(2 * v - a.level_off);
    }
    dst[t] = v;
  }
}

__global__ void __launch_bounds__(kThreads) direct_kernel(const DirectArgs a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int img0 = (blockIdx.x / a.bands) * a.tile_imgs;
  const int oy0 = (blockIdx.x % a.bands) * a.tile_rows;
  const int imgs = min(a.tile_imgs, a.b - img0);
  const int rows = min(a.tile_rows, a.oh - oy0);
  const int halo = a.ksize - 1;

  int hin = rows + a.n_layers * halo;
  int win = a.w;
  int cp = chan_pad(a.c);
  int8_t* in = smem;
  stage_input(a, in, img0, oy0, imgs, hin);
  __syncthreads();

  for (int j = 0; j < a.n_layers; ++j) {
    const DirectLayer& L = a.layer[j];
    LayerOut o = {};
    if (j + 1 < a.n_layers) {
      o.next = smem + ((j + 1) % 2 ? a.region1 : 0);
      o.next_cp = chan_pad(L.n_out);
      if (o.next_cp != L.n_out) {   // the pad channels must be zero levels
        const int bytes = imgs * (hin - halo) * (win - halo) * o.next_cp;
        for (int t = threadIdx.x; t < bytes; t += blockDim.x) o.next[t] = 0;
        __syncthreads();
      }
    } else {
      o.out = a.out;
      o.out_base = static_cast<size_t>(img0) * a.oh * a.ow +
                   static_cast<size_t>(oy0) * a.ow;
      o.img_pixels = a.oh * a.ow;
    }
    if (cp % kVec == 0) {
      direct_layer<kVec>(in, imgs, hin, win, cp, a.ksize, L, a.nthr,
                         a.level_off, o);
    } else {
      direct_layer<4>(in, imgs, hin, win, cp, a.ksize, L, a.nthr,
                      a.level_off, o);
    }
    __syncthreads();
    in = o.next;
    hin -= halo;
    win -= halo;
    cp = o.next_cp;
  }
}

// Shared-memory bytes of a tile of `imgs` images × `rows` final output rows:
// layer j's input levels sit in buffer j % 2. Sets the second buffer's
// offset.
size_t tile_smem(const DirectArgs& a, int imgs, int rows, int* region1) {
  size_t region[2] = {0, 0};
  const int halo = a.ksize - 1;
  int hin = rows + a.n_layers * halo;
  int win = a.w;
  int c = a.c;
  for (int j = 0; j < a.n_layers; ++j) {
    const size_t bytes =
        static_cast<size_t>(imgs) * hin * win * chan_pad(c);
    region[j % 2] = std::max(region[j % 2], (bytes + 15) / 16 * 16);
    hin -= halo;
    win -= halo;
    c = a.layer[j].n_out;
  }
  *region1 = static_cast<int>(region[0]);
  return region[0] + region[1];
}

// Validate, choose the tile and launch. The layers' fields are set.
int launch_direct(DirectArgs& a, cudaStream_t stream) {
  const int halo = a.ksize - 1;
  if (a.b < 0 || a.c < 1 || a.ksize < 1 || a.n_layers < 1 ||
      a.n_layers > kDirectMaxLayers || (a.level_off != 1 && a.level_off != 3) ||
      a.nthr < 1 || a.nthr > kMaxThr ||
      a.h - a.n_layers * halo < 1 || a.w - a.n_layers * halo < 1) {
    return cudaErrorInvalidValue;
  }
  int c = a.c;
  for (int j = 0; j < a.n_layers; ++j) {
    const DirectLayer& L = a.layer[j];
    const int cp = chan_pad(c);
    if (L.w == nullptr || L.n_out < 1 || L.thr == nullptr ||
        L.wstride < a.ksize * a.ksize * cp ||
        L.wstride % (cp % kVec == 0 ? kVec : 4) != 0) {
      return cudaErrorInvalidValue;
    }
    c = L.n_out;
  }
  a.oh = a.h - a.n_layers * halo;
  a.ow = a.w - a.n_layers * halo;
  if (static_cast<long long>(a.b) * a.oh * a.ow > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (a.b == 0) return cudaSuccess;

  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  sms = std::max(sms, 1);

  // Whole images where one fits the tile budget: several to a block only
  // for small maps (kTargetPixels; more images per block cost blocks per SM
  // at larger maps, through shared memory), and no fewer blocks than two per
  // SM where the batch allows. Else a band of as many output rows as fit.
  int imgs = 1;
  int rows = a.oh;
  if (tile_smem(a, 1, a.oh, &a.region1) <= static_cast<size_t>(kTileSmem)) {
    const int map = a.oh * a.ow;
    imgs = std::min((kTargetPixels + map - 1) / map,
                    std::max(1, (a.b + 2 * sms - 1) / (2 * sms)));
    imgs = std::max(1, std::min(imgs, a.b));
    while (imgs > 1 && tile_smem(a, imgs, rows, &a.region1) >
                           static_cast<size_t>(kTileSmem)) {
      --imgs;
    }
  } else {
    while (rows > 1 && tile_smem(a, 1, rows, &a.region1) >
                           static_cast<size_t>(kTileSmem)) {
      --rows;
    }
  }
  const size_t smem = tile_smem(a, imgs, rows, &a.region1);
  err = allow_smem(direct_kernel, smem);
  if (err != cudaSuccess) return err;
  a.tile_imgs = imgs;
  a.tile_rows = rows;
  a.bands = (a.oh + rows - 1) / rows;
  const long long blocks =
      static_cast<long long>((a.b + imgs - 1) / imgs) * a.bands;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  direct_kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

DirectArgs input_args(const void* x, int b, int h, int w, int c, int ksize,
                      int input_levels, int nthr, int abits, void* out) {
  DirectArgs a = {};
  a.x = static_cast<const int8_t*>(x);
  a.b = b;
  a.h = h;
  a.w = w;
  a.c = c;
  a.ksize = ksize;
  a.input_levels = input_levels;
  a.level_off = abits == 1 ? 1 : (abits == 2 ? 3 : 0);
  a.nthr = nthr;
  a.out = static_cast<int8_t*>(out);
  return a;
}

}  // namespace
}  // namespace bnn

extern "C" {

int bnn_dense_codes(const void* x, int m, int k0, const void* tiles, int k32,
                    int n_out, const void* wsum, const void* thr, int nthr,
                    int abits, void* out, void* stream);

// One layer. x: int8 codes [b, h, w, c]; wt: int8 levels [n_out, k32] with
// k32 = round_up(ksize²·c, 32), (ki, kj, c) order, zero past K; tiles: the
// same weights as 128-byte K tiles (WeightMatrix.tiles: what
// bnn_dense_codes reads); wsum: int32 [n_out], the column sums of wt; thr:
// int32 [nthr, n_out], or null with nthr = 0 for int32 output;
// out: [b, h-ksize+1, w-ksize+1, n_out], int8 codes or int32.
int bnn_conv_direct(const void* x, int b, int h, int w, int c, int ksize,
                    const void* wt, const void* tiles, int k32, int n_out,
                    const void* wsum, const void* thr, int nthr, int abits,
                    void* out, void* stream) {
  using namespace bnn;
  if ((thr == nullptr) != (nthr == 0)) return cudaErrorInvalidValue;
  if (thr == nullptr) {
    return launch_conv<kConvAcc>(x, b, h, w, c, ksize, 0, wt, k32, n_out,
                                 wsum, nullptr, 0, abits, out,
                                 static_cast<cudaStream_t>(stream));
  }
  if (b > 0 && c > 0 && h == ksize && w == ksize) {
    // the kernel covers the map: a dense layer on [b, ksize²·c] rows
    return bnn_dense_codes(x, b, ksize * ksize * c, tiles, k32, n_out, wsum,
                           thr, nthr, abits, out, stream);
  }
  return launch_conv<kConvCodes>(x, b, h, w, c, ksize, 0, wt, k32, n_out,
                                 wsum, thr, nthr, abits, out,
                                 static_cast<cudaStream_t>(stream));
}

// n_layers chained layers, each thresholded (1 <= nthr <= 3). x: int8 codes
// [b, h, w, c], or levels if input_levels; w_ptrs, wstrides, n_outs,
// thr_ptrs: host arrays, one entry per layer: int8 levels [n_out, wstride]
// with tap t's channels at t * chan_pad(c) (zero levels in the pad), and
// int32 thresholds [nthr, n_out];
// out: int8 codes [b, h-n(ksize-1), w-n(ksize-1), n_outs[n-1]].
int bnn_conv_chain_direct(const void* x, int b, int h, int w, int c,
                          int ksize, int input_levels,
                          const void* const* w_ptrs, const int* wstrides,
                          const int* n_outs, const void* const* thr_ptrs,
                          int n_layers, int nthr, int abits, void* out,
                          void* stream) {
  using namespace bnn;
  if (n_layers < 1 || n_layers > kDirectMaxLayers || nthr < 1) {
    return cudaErrorInvalidValue;
  }
  DirectArgs a =
      input_args(x, b, h, w, c, ksize, input_levels, nthr, abits, out);
  a.n_layers = n_layers;
  for (int j = 0; j < n_layers; ++j) {
    a.layer[j] = {static_cast<const int8_t*>(w_ptrs[j]), wstrides[j],
                  n_outs[j], static_cast<const int32_t*>(thr_ptrs[j])};
  }
  return launch_direct(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
