// Direct (no-im2col) quantized convs: one stride-1 VALID K×K layer (entry
// bnn_conv_direct), or several chained layers whose intermediate codes
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
// bnn_conv_chain_direct (on no route, as in the JAX package) is the chained
// form: n stride-1 VALID K×K convs, each thresholded, whose intermediate
// codes never leave shared memory. That property is what sets it apart from
// conv_chain.cu (one launch a layer, device memory between them), so it is
// kept. What bounds it is operations, as above (114 G for CNV-W1A1's two
// chains at batch 1024: 0.058 ms), so it runs conv_tile.cuh's inner loop on
// the int8 tensor cores, chain_kernel below:
// - a persistent block of 16 warps owns whole images, as many as fit (2 of
//   CNV's 32×32 images through conv0-1, 3 of its 14×14 maps through
//   conv2-3), and walks the batch in such tiles;
// - per layer the weights (WeightMatrix.nk32, [N, K] rows pitched ≡ 16 mod
//   32 bytes) are staged by cp.async in column chunks of at most 76 KB, the
//   thresholds folded with wsum onto the raw dot of codes
//   (mma_tile.cuh::stage_thresholds);
// - a warp item is 32 output pixels × 64 channels. Its A fragments are read
//   by ldmatrix from the previous layer's codes where they lie in shared
//   memory, tap (ki, kj) at a shifted pixel offset (C % 32 == 0); any other
//   C (the 3-channel image, C = 24) first gathers K²·C patch rows, up to 512
//   pixels at a time, and runs the same loop over them;
// - the epilogue thresholds in registers and writes codes, not levels (the
//   wsum fold needs no decode), into the other of two shared buffers at a
//   pixel pitch ≡ 16 (mod 32) bytes; the last layer's codes leave as 16-byte
//   stores to device memory.
// A chain whose single image does not fit in shared memory beside a weight
// chunk (a map of 64×64×64, say) is not this kernel's: the entry answers
// kChainNoImageFits and launches nothing, and the wrapper runs the chain one
// layer a launch on conv_chain.cu's kernel.
// The dp4a kernel this replaced (a thread per 8 pixels and one channel,
// weights streamed from L2 by every thread) took 2.43 ms for CNV-W1A1's two
// chains at batch 1024 on an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md §6
// has the times of this one.
#include <algorithm>

#include "conv_tile.cuh"

namespace bnn {
namespace {

constexpr int kChainMaxLayers = 8;      // ops/fused_mlp.py MAX_LAYERS
constexpr int kChainNoImageFits = -1;   // no cudaError_t; ops/_build.py DECLINED
constexpr int kChainWarps = 16;
constexpr int kChainThreads = 32 * kChainWarps;
constexpr int kChainWeightBytes = 76 * 1024;   // a staged weight chunk's aim
constexpr int kChainPatchBytes = 48 * 1024;    // the patch buffer's aim

struct ChainLayer {
  const int8_t* wt;      // [n_out, k32] levels, (ki, kj, c) order, zero past K
  const int32_t* wsum;   // [n_out]
  const int32_t* thr;    // [nthr, n_out]
  int k32, n_out;
  int n_chunk;           // weight columns staged at once
  int w_pitch;           // bytes per staged weight row
  int gather;            // the input's channels are no multiple of 32 (or the
                         // image is not 16-byte aligned): patch rows are
                         // gathered, else the taps are read in place
  int in_pitch;          // bytes per input pixel where this layer reads it
  int a_pitch;           // bytes per gathered patch row
};

struct ChainArgs {
  const int8_t* x;       // [b, h, w, c] codes, or levels if input_levels
  int b, h, w, c;
  int ksize;
  int input_levels;
  int level_off;
  int nthr;
  int n_layers;
  ChainLayer layer[kChainMaxLayers];
  int8_t* out;           // [b, oh, ow, n_last] codes
  int out_vec;           // out is 16-byte aligned and n_last % 16 == 0
  int imgs;              // images a tile holds
  int w_bytes;           // bytes of the weight buffer
  int cols_pad;          // staged threshold columns
  int region_bytes[2];   // layer j reads buffer j % 2 and writes the other
  int ptile;             // pixels gathered at once
};

// Threshold the item's accumulators and store the codes into the next
// layer's input in shared memory: dst is item row 0, column 0; rows of
// `pitch` bytes (even, as the item's first column is).
template <int NTHR, bool FULL>
__device__ __forceinline__ void item_store_smem_n(
    const ItemAcc& acc, const int32_t* thr_s, int cols_pad, int8_t* dst,
    int pitch, int rows, int cols, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  const int32_t* thr_lane = thr_s + 2 * t;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int code[2][2];
      block_codes<NTHR>(acc, mb, j, thr_lane, cols_pad, code);
      const int n = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = 16 * mb + 8 * h + g;
        if (!FULL && (rr >= rows || n >= cols)) continue;
        int8_t* o = dst + rr * pitch + n;
        if (FULL || n + 1 < cols) {
          *reinterpret_cast<uint16_t*>(o) =
              static_cast<uint16_t>(code[h][0] | (code[h][1] << 8));
        } else {
          o[0] = static_cast<int8_t>(code[h][0]);
        }
      }
    }
  }
}

// The same with the number of thresholds (1..3) chosen at run time; a whole
// item (32 rows × 64 columns) takes the form without the edge tests.
template <int NTHR>
__device__ __forceinline__ void item_store_smem_t(
    const ItemAcc& acc, const int32_t* thr_s, int cols_pad, int8_t* dst,
    int pitch, int rows, int cols, int lane) {
  if (rows == kItemRows && cols == kItemCols) {
    item_store_smem_n<NTHR, true>(acc, thr_s, cols_pad, dst, pitch, rows,
                                  cols, lane);
  } else {
    item_store_smem_n<NTHR, false>(acc, thr_s, cols_pad, dst, pitch, rows,
                                   cols, lane);
  }
}

__device__ __forceinline__ void item_store_smem(
    const ItemAcc& acc, const int32_t* thr_s, int cols_pad, int nthr,
    int8_t* dst, int pitch, int rows, int cols, int lane) {
  if (nthr == 1) {
    item_store_smem_t<1>(acc, thr_s, cols_pad, dst, pitch, rows, cols, lane);
  } else if (nthr == 2) {
    item_store_smem_t<2>(acc, thr_s, cols_pad, dst, pitch, rows, cols, lane);
  } else {
    item_store_smem_t<3>(acc, thr_s, cols_pad, dst, pitch, rows, cols, lane);
  }
}

// The geometry of one layer of a tile.
struct ChainMap {
  int hin, win, cin;     // the input map and its channels
  int wout, map;         // the output's width and pixels per image
};

// Byte offset, within the layer's input, of tap (0, 0) of output pixel p of
// the tile (pixels of all its images flattened).
__device__ __forceinline__ int chain_pixel(const ChainMap& g, int p,
                                           int pitch) {
  const int i = p / g.map;
  const int q = p - i * g.map;
  const int y = q / g.wout;
  return ((i * g.hin + y) * g.win + (q - y * g.wout)) * pitch;
}

// Gather the K²·C patch rows of pixels [p0, p0 + count) of the tile from
// `in` (device or shared memory, `pitch` bytes a pixel) into `buf`, as they
// are (codes stay codes). A patch row is K runs of K·C contiguous bytes where
// the pixels lie back to back (device memory), else K² runs of C bytes. A
// thread owns one pixel and every (threads / slots)-th run of it (slots: the
// pixels gathered at once, at most as many as the block has threads),
// neighbouring threads neighbouring pixels.
__device__ __forceinline__ void chain_gather(const ChainMap& g, int ksize,
                                             const int8_t* in, int pitch,
                                             int p0, int count, int slots,
                                             int8_t* buf, int a_pitch) {
  const int r = threadIdx.x % slots;
  if (r >= count) return;
  const bool rows = pitch == g.cin;
  const int run = rows ? ksize * g.cin : g.cin;
  const int nruns = rows ? ksize : ksize * ksize;
  const int8_t* const pix = in + chain_pixel(g, p0 + r, pitch);
  int8_t* const row = buf + r * a_pitch;
  for (int q = threadIdx.x / slots; q < nruns; q += blockDim.x / slots) {
    const int ki = rows ? q : q / ksize;
    const int kj = rows ? 0 : q - ki * ksize;
    const int8_t* src = pix + (ki * g.win + kj) * pitch;
    int8_t* dst = row + q * run;
    // loads first, four at a time: a byte store may alias the next load
    // for all the compiler knows, and would serialize them
    int j = 0;
    for (; j + 4 <= run; j += 4) {
      const int8_t v0 = src[j], v1 = src[j + 1];
      const int8_t v2 = src[j + 2], v3 = src[j + 3];
      dst[j] = v0;
      dst[j + 1] = v1;
      dst[j + 2] = v2;
      dst[j + 3] = v3;
    }
    for (; j < run; ++j) dst[j] = src[j];
  }
  // the K padding: the weights are zero there, the bytes must only exist
}

__global__ void __launch_bounds__(kChainThreads, 1)
chain_kernel(const ChainArgs a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int8_t* const wsm = smem;
  int32_t* const thr_s = reinterpret_cast<int32_t*>(smem + a.w_bytes);
  int8_t* const stages = reinterpret_cast<int8_t*>(thr_s + a.nthr * a.cols_pad);
  int8_t* const stage = stages + warp * kStageBytes;
  int8_t* const region[2] = {stages + kChainWarps * kStageBytes,
                             stages + kChainWarps * kStageBytes +
                                 a.region_bytes[0]};
  int8_t* const patches = region[1] + a.region_bytes[1];

  const int ntiles = (a.b + a.imgs - 1) / a.imgs;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int img0 = tile * a.imgs;
    const int imgs = min(a.imgs, a.b - img0);
    ChainMap g = {a.h, a.w, a.c, 0, 0};
    const int8_t* const x0 =
        a.x + static_cast<size_t>(img0) * a.h * a.w * a.c;
    __syncthreads();   // the last tile's reads of the buffers are done
    if (!a.layer[0].gather) {
      // the tile's images as they are, each pixel's c bytes pitched
      const int cv = a.c / kVec;
      const unsigned dst = smem_addr(region[0]);
      for (int i = threadIdx.x; i < imgs * a.h * a.w * cv; i += blockDim.x) {
        const int pix = i / cv;
        const int v = i - pix * cv;
        cp_async16(dst + pix * a.layer[0].in_pitch + v * kVec,
                   x0 + static_cast<size_t>(i) * kVec);
      }
    }   // (it lands with the first layer's weights)

    for (int j = 0; j < a.n_layers; ++j) {
      const ChainLayer& L = a.layer[j];
      const bool last = j + 1 == a.n_layers;
      g.wout = g.win - a.ksize + 1;
      g.map = (g.hin - a.ksize + 1) * g.wout;
      const int pixels = imgs * g.map;
      const int8_t* const in = j == 0 && L.gather ? x0 : region[j % 2];
      int8_t* const nxt = region[(j + 1) % 2];
      const int out_pitch = last ? 0 : a.layer[j + 1].in_pitch;
      EpilogueArgs ep = {L.thr, L.wsum, a.nthr, L.n_out, a.level_off,
                         !(j == 0 && a.input_levels)};
      const int ks = L.gather ? 1 : a.ksize;
      const int c_eff = L.gather ? L.k32 : g.cin;
      const int kvec = L.k32 / kVec;
      const int ptile = L.gather ? a.ptile : pixels;

      for (int nc0 = 0; nc0 < L.n_out; nc0 += L.n_chunk) {
        const int ncols = min(L.n_chunk, L.n_out - nc0);
        // the last pass's reads of the weights and thresholds are done, and
        // the previous layer's codes are written
        __syncthreads();
        stage_thresholds(thr_s, a.cols_pad, ep, nc0, ncols);
        {
          const unsigned dst = smem_addr(wsm);
          const int8_t* src = L.wt + static_cast<size_t>(nc0) * L.k32;
          for (int i = threadIdx.x; i < ncols * kvec; i += blockDim.x) {
            const int n = i / kvec;
            const int v = i - n * kvec;
            cp_async16(dst + n * L.w_pitch + v * kVec,
                       src + static_cast<size_t>(i) * kVec);
          }
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();

        for (int pt0 = 0; pt0 < pixels; pt0 += ptile) {
          const int count = min(ptile, pixels - pt0);
          if (L.gather) {
            chain_gather(g, a.ksize, in, L.in_pitch, pt0, count, a.ptile,
                         patches, L.a_pitch);
            __syncthreads();
          }
          const int m_items = (count + kItemRows - 1) / kItemRows;
          const int n_items = (ncols + kItemCols - 1) / kItemCols;
          for (int item = warp; item < m_items * n_items;
               item += kChainWarps) {
            const int mi = item % m_items;
            const int ni = item / m_items;
            const int m0 = mi * kItemRows;        // within this pass's pixels
            const int n0 = ni * kItemCols;        // within the staged chunk
            const int cols = min(kItemCols, ncols - n0);

            unsigned a_addr[2], b_addr[4];
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) {
              // rows past the ragged edge read the last real pixel's data
              const int m = min(m0 + 16 * mb + a_lane_row(lane), count - 1);
              a_addr[mb] =
                  (L.gather ? smem_addr(patches) + m * L.a_pitch
                            : smem_addr(in) +
                                  chain_pixel(g, pt0 + m, L.in_pitch)) +
                  a_lane_k(lane);
            }
#pragma unroll
            for (int jp = 0; jp < 4; ++jp) {
              const int n = min(n0 + 16 * jp + b_lane_col(lane), ncols - 1);
              b_addr[jp] = smem_addr(wsm) + n * L.w_pitch + b_lane_k(lane);
            }

            ItemAcc acc;
            item_clear(acc);
            const int steps = c_eff / kMmaK;
            unsigned koff = 0;
            for (int ki = 0; ki < ks; ++ki) {
              for (int kj = 0; kj < ks; ++kj) {
                const unsigned tap = (ki * g.win + kj) * L.in_pitch;
                const unsigned aa[2] = {a_addr[0] + tap, a_addr[1] + tap};
                const unsigned bb[4] = {b_addr[0] + koff, b_addr[1] + koff,
                                        b_addr[2] + koff, b_addr[3] + koff};
                item_mma(acc, aa, bb, steps, cols);
                koff += c_eff;
              }
            }

            const int col0 = nc0 + n0;
            const int rows = min(kItemRows, count - m0);
            if (last) {
              item_store_codes(
                  acc, thr_s + n0, a.cols_pad, a.nthr, stage, a.out, L.n_out,
                  static_cast<size_t>(img0) * g.map + pt0 + m0, rows, col0,
                  cols, a.out_vec && col0 % kVec == 0 && cols % kVec == 0,
                  lane);
            } else {
              item_store_smem(acc, thr_s + n0, a.cols_pad, a.nthr,
                              nxt + (pt0 + m0) * out_pitch + col0, out_pitch,
                              rows, cols, lane);
            }
          }
          if (L.gather) __syncthreads();   // the patch buffer is free
        }
      }
      g.hin -= a.ksize - 1;
      g.win -= a.ksize - 1;
      g.cin = L.n_out;
    }
  }
}

// Size the fused kernel's tile: per layer how it reads its input and how
// many weight columns it stages at once, then as many whole images as fit
// beside them (no more than leave every SM a tile). Returns the dynamic
// shared memory in bytes, 0 if not even one image fits. The layers' wt, k32
// and n_out are set.
size_t plan_chain(ChainArgs& a, int sms) {
  const int halo = a.ksize - 1;
  int hin = a.h, win = a.w, cin = a.c;
  size_t per_img[2] = {0, 0};
  size_t w_bytes = 0;
  int max_cols = 0, patch_pitch = 0;
  for (int j = 0; j < a.n_layers; ++j) {
    ChainLayer& L = a.layer[j];
    L.gather = cin % kMmaK != 0 ||
               (j == 0 && reinterpret_cast<uintptr_t>(a.x) % kVec != 0);
    L.in_pitch = j == 0 && L.gather ? cin : padded_pitch(cin);
    L.a_pitch = padded_pitch(L.k32);
    L.w_pitch = padded_pitch(L.k32);
    L.n_chunk = round_up(L.n_out, 8);
    while (L.n_chunk > 8 && static_cast<size_t>(L.n_chunk) * L.w_pitch >
                                static_cast<size_t>(kChainWeightBytes)) {
      L.n_chunk = round_up(L.n_chunk / 2, 8);
    }
    w_bytes = std::max(w_bytes, static_cast<size_t>(L.n_chunk) * L.w_pitch);
    max_cols = std::max(max_cols, L.n_chunk);
    if (j > 0 || !L.gather) {
      per_img[j % 2] = std::max(
          per_img[j % 2], static_cast<size_t>(hin) * win * L.in_pitch);
    }
    if (L.gather) patch_pitch = std::max(patch_pitch, L.a_pitch);
    hin -= halo;
    win -= halo;
    cin = L.n_out;
  }
  a.cols_pad = round_up(max_cols, kItemCols);
  // as many gathered pixels at once as the patch buffer's aim allows: an
  // item for every warp where the patch rows are short (the image's K = 27)
  a.ptile = std::min(kChainThreads,
                     std::max(kItemRows, kChainPatchBytes /
                                             std::max(patch_pitch, 1) /
                                             kItemRows * kItemRows));
  const size_t fixed = w_bytes +
                       epilogue_smem(a.nthr, max_cols, kChainWarps) +
                       static_cast<size_t>(a.ptile) * patch_pitch;
  const auto smem_of = [&](int imgs) {
    return fixed + imgs * (per_img[0] + per_img[1]);
  };
  if (smem_of(1) > static_cast<size_t>(kMaxSmem)) return 0;
  const int cap = std::max(1, std::min(a.b, (a.b + sms - 1) / sms));
  int imgs = 1;
  while (imgs < cap && smem_of(imgs + 1) <= static_cast<size_t>(kMaxSmem)) {
    ++imgs;
  }
  a.imgs = imgs;
  a.w_bytes = static_cast<int>(w_bytes);
  a.region_bytes[0] = static_cast<int>(imgs * per_img[0]);
  a.region_bytes[1] = static_cast<int>(imgs * per_img[1]);
  return smem_of(imgs);
}

// Validate and fill a ChainArgs from the entry point's arguments. Returns
// cudaSuccess or the error.
int chain_args(ChainArgs& a, const void* x, int b, int h, int w, int c,
               int ksize, int input_levels, const void* const* w_ptrs,
               const int* k32s, const int* n_outs,
               const void* const* wsum_ptrs, const void* const* thr_ptrs,
               int n_layers, int nthr, int abits, void* out) {
  if (n_layers < 1 || n_layers > kChainMaxLayers || nthr < 1 ||
      nthr > 3 || (abits != 1 && abits != 2) || b < 0 || c < 1 ||
      ksize < 1 || h - n_layers * (ksize - 1) < 1 ||
      w - n_layers * (ksize - 1) < 1) {
    return cudaErrorInvalidValue;
  }
  a = {};
  a.x = static_cast<const int8_t*>(x);
  a.b = b;
  a.h = h;
  a.w = w;
  a.c = c;
  a.ksize = ksize;
  a.input_levels = input_levels;
  a.level_off = abits == 1 ? 1 : 3;
  a.nthr = nthr;
  a.n_layers = n_layers;
  a.out = static_cast<int8_t*>(out);
  int cin = c;
  for (int j = 0; j < n_layers; ++j) {
    if (n_outs[j] < 1 || k32s[j] != round_up(ksize * ksize * cin, kMmaK)) {
      return cudaErrorInvalidValue;
    }
    ChainLayer& L = a.layer[j];
    L.k32 = k32s[j];
    L.n_out = n_outs[j];
    L.wt = static_cast<const int8_t*>(w_ptrs[j]);
    L.wsum = static_cast<const int32_t*>(wsum_ptrs[j]);
    L.thr = static_cast<const int32_t*>(thr_ptrs[j]);
    if (L.wt == nullptr || L.wsum == nullptr || L.thr == nullptr ||
        reinterpret_cast<uintptr_t>(L.wt) % kVec != 0) {
      return cudaErrorInvalidValue;
    }
    cin = n_outs[j];
  }
  const long long oh = h - n_layers * (ksize - 1);
  const long long ow = w - n_layers * (ksize - 1);
  if (static_cast<long long>(b) * h * w > 0x7fffffffLL / std::max(c, 1) ||
      static_cast<long long>(b) * oh * ow > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  a.out_vec = a.layer[n_layers - 1].n_out % kVec == 0 &&
              reinterpret_cast<uintptr_t>(out) % kVec == 0;
  return cudaSuccess;
}

int device_sms(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  return err;
}

}  // namespace
}  // namespace bnn

extern "C" {

int bnn_dense_codes(const void* x, int m, int k0, const void* tiles, int k32,
                    int n_out, const void* wsum, const void* thr, int nthr,
                    int abits, int input_levels, void* out, void* stream);

// One layer. x: int8 codes [b, h, w, c]; wt: int8 levels [n_out, k32] with
// k32 = round_up(ksize²·c, 32), (ki, kj, c) order, zero past K; tiles: the
// same weights as 128-byte K tiles (WeightMatrix.tiles: what
// bnn_dense_codes reads); wsum: int32 [n_out], the column sums of wt; thr:
// int32 [nthr, n_out], or null with nthr = 0 for int32 output;
// input_levels: the codes are their own levels (unsigned);
// out: [b, h-ksize+1, w-ksize+1, n_out], int8 codes or int32.
int bnn_conv_direct(const void* x, int b, int h, int w, int c, int ksize,
                    const void* wt, const void* tiles, int k32, int n_out,
                    const void* wsum, const void* thr, int nthr, int abits,
                    int input_levels, void* out, void* stream) {
  using namespace bnn;
  if ((thr == nullptr) != (nthr == 0)) return cudaErrorInvalidValue;
  if (thr == nullptr) {
    return launch_conv<kConvAcc>(x, b, h, w, c, ksize, input_levels, wt,
                                 k32, n_out, wsum, nullptr, 0, abits, out,
                                 static_cast<cudaStream_t>(stream));
  }
  if (b > 0 && c > 0 && h == ksize && w == ksize) {
    // the kernel covers the map: a dense layer on [b, ksize²·c] rows
    return bnn_dense_codes(x, b, ksize * ksize * c, tiles, k32, n_out, wsum,
                           thr, nthr, abits, input_levels, out, stream);
  }
  return launch_conv<kConvCodes>(x, b, h, w, c, ksize, input_levels, wt,
                                 k32, n_out, wsum, thr, nthr, abits, out,
                                 static_cast<cudaStream_t>(stream));
}

// n_layers chained layers, each thresholded (1 <= nthr <= 3). x: int8 codes
// [b, h, w, c], or levels if input_levels; w_ptrs, k32s, n_outs, wsum_ptrs,
// thr_ptrs: host arrays, one entry per layer: int8 levels [n_out, k32] with
// k32 = round_up(ksize²·c_in, 32), (ki, kj, c) order, zero past K; their
// int32 column sums [n_out]; int32 thresholds [nthr, n_out];
// out: int8 codes [b, h-n(ksize-1), w-n(ksize-1), n_outs[n-1]].
// Answers kChainNoImageFits (−1), with nothing launched, where not even one
// image fits in shared memory beside a weight chunk.
int bnn_conv_chain_direct(const void* x, int b, int h, int w, int c,
                          int ksize, int input_levels,
                          const void* const* w_ptrs, const int* k32s,
                          const int* n_outs, const void* const* wsum_ptrs,
                          const void* const* thr_ptrs, int n_layers, int nthr,
                          int abits, void* out, void* stream) {
  using namespace bnn;
  if (w_ptrs == nullptr || wsum_ptrs == nullptr || thr_ptrs == nullptr) {
    return cudaErrorInvalidValue;
  }
  ChainArgs a;
  int err = chain_args(a, x, b, h, w, c, ksize, input_levels, w_ptrs, k32s,
                       n_outs, wsum_ptrs, thr_ptrs, n_layers, nthr, abits,
                       out);
  if (err != cudaSuccess) return err;
  if (b == 0) return cudaSuccess;
  int sms = 0;
  if ((err = device_sms(&sms)) != cudaSuccess) return err;
  const size_t smem = plan_chain(a, std::max(sms, 1));
  if (smem == 0) return kChainNoImageFits;
  if ((err = allow_smem(chain_kernel, smem)) != cudaSuccess) return err;
  const int ntiles = (b + a.imgs - 1) / a.imgs;
  chain_kernel<<<std::min(ntiles, std::max(sms, 1)), kChainThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
