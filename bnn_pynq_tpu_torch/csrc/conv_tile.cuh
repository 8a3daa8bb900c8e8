// The persistent implicit-GEMM conv kernel of the tensor-core convs: one
// stride-1 VALID K×K quantized conv on NHWC int8 codes (or raw int8 levels),
// instantiated with three epilogues:
//   kConvCodes  MultiThreshold → int8 codes   (conv_chain.cu::bnn_conv_layer,
//               conv_direct.cu::bnn_conv_direct with thresholds)
//   kConvAcc    the int32 accumulators        (bnn_conv_direct without)
//   kConvPool   the 2×2 max-pool of the codes (bnn_conv_layer with pool): a
//               tile's pixels run window by window, each window's largest
//               accumulator is thresholded (mma_tile.cuh item_store_pooled)
// One kernel body, one launcher (launch_conv); the design and what bounds it
// are told in conv_chain.cu.
#pragma once

#include "mma_tile.cuh"

namespace bnn {
namespace {

enum ConvOut : int { kConvCodes = 0, kConvAcc = 1, kConvPool = 2 };

struct ConvArgs {
  const int8_t* x;     // [b, h, w, c]
  int h, w, c;
  int ksize;
  int input_levels;
  const int8_t* wt;    // [n_out, k32] levels, (ki, kj, c) order, zero past K
  int k32;
  void* out;           // [b, oh, ow, n_out] int8 codes, or int32 accumulators
  int oh, ow;
  int pixels;          // b * oh * ow
  int tile;            // output pixels per tile, a multiple of kItemRows
                       // (kConvPool: 4 a pooled pixel)
  int n_chunk;         // weight columns staged at once
  int halo;            // 1: input rows staged, the mma reads them in place;
                       // 0: a patch row per pixel gathered from device memory
  int a_pitch;         // halo: bytes per staged pixel; else: per patch row
  int patch_bytes;     // bytes of the patch buffer (0 with halo)
  int rows_bytes;      // bytes of one input-row buffer (0 without)
  int w_pitch;         // bytes per staged weight row
  int out_vec;         // codes: out is 16-byte aligned and n_out % 16 == 0;
                       // accumulators: 8-byte aligned and n_out % 2 == 0;
                       // pooled codes: 2-byte aligned and n_out % 2 == 0
  EpilogueArgs ep;
};

// The first input row (of the flattened [b·h] row space) under tile pixel
// p. Tile pixels are the output pixels of the flattened [b·oh·ow] grid in
// order; with kConvPool, window by window: pixel 4q + s is position s (row
// s / 2, column s % 2) of the 2×2 window of pooled pixel q of the flattened
// [b·oh/2·ow/2] grid. Either way the rows that pixels [p0, p1] need (with
// kConvPool p0 and p1 + 1 on window bounds) are input_row_of(p0) ..
// input_row_of(p1) + ksize − 1: contiguous in memory, images included.
template <int OUT>
__device__ __forceinline__ int input_row_of(const ConvArgs& a, int p) {
  if constexpr (OUT == kConvPool) {
    const int ph = a.oh >> 1;
    const int q = (p >> 2) / (a.ow >> 1);    // flattened pooled row
    return (q / ph) * a.h + 2 * (q % ph) + ((p >> 1) & 1);
  } else {
    const int q = p / a.ow;               // flattened output row
    return (q / a.oh) * a.h + q % a.oh;
  }
}

// The output column of tile pixel p (input_row_of's order).
template <int OUT>
__device__ __forceinline__ int column_of(const ConvArgs& a, int p) {
  if constexpr (OUT == kConvPool) {
    return 2 * ((p >> 2) % (a.ow >> 1)) + (p & 1);
  } else {
    return p % a.ow;
  }
}

// Start the copy of the input rows of pixels [p0, p1] into `buf`, each
// pixel's c bytes pitched to a_pitch.
template <int OUT>
__device__ __forceinline__ void copy_rows_async(const ConvArgs& a, int p0,
                                                int p1, int8_t* buf) {
  const int first = input_row_of<OUT>(a, p0);
  const int count = input_row_of<OUT>(a, p1) + a.ksize - first;
  const int8_t* src = a.x + static_cast<size_t>(first) * a.w * a.c;
  const unsigned dst = smem_addr(buf);
  const int cv = a.c / kVec;
  for (int i = threadIdx.x; i < count * a.w * cv; i += blockDim.x) {
    const int pix = i / cv;
    const int v = i - pix * cv;
    cp_async16(dst + pix * a.a_pitch + v * kVec,
               src + static_cast<size_t>(i) * kVec);
  }
}

// Gather the K²·C patch rows of pixels [p0, p1] as levels into `buf`. A
// patch row is K runs of K·C contiguous input bytes, one per ki; a thread
// owns one pixel and every (threads / tile)-th run of it (a tile has at
// most as many pixels as the block has threads), neighbouring threads
// neighbouring pixels.
template <int OUT>
__device__ __forceinline__ void gather_patches(const ConvArgs& a, int p0,
                                               int p1, int8_t* buf) {
  const int run = a.ksize * a.c;
  const int parts = blockDim.x / a.tile;
  const int tid = threadIdx.x;
  const int r = tid % a.tile;
  if (p0 + r > p1) return;
  const int p = p0 + r;
  const size_t row0 = input_row_of<OUT>(a, p);
  const int sub = a.input_levels ? 0 : a.ep.level_off;
  const int mul = a.input_levels ? 1 : 2;
  for (int ki = tid / a.tile; ki < a.ksize; ki += parts) {
    const int8_t* src =
        a.x + ((row0 + ki) * a.w + column_of<OUT>(a, p)) * a.c;
    int8_t* dst = buf + r * a.a_pitch + ki * run;
    // loads first, four at a time: a byte store may alias the next load
    // for all the compiler knows, and would serialize them
    int j = 0;
    for (; j + 4 <= run; j += 4) {
      const int v0 = __ldg(src + j), v1 = __ldg(src + j + 1);
      const int v2 = __ldg(src + j + 2), v3 = __ldg(src + j + 3);
      dst[j] = static_cast<int8_t>(mul * v0 - sub);
      dst[j + 1] = static_cast<int8_t>(mul * v1 - sub);
      dst[j + 2] = static_cast<int8_t>(mul * v2 - sub);
      dst[j + 3] = static_cast<int8_t>(mul * v3 - sub);
    }
    for (; j < run; ++j) {
      dst[j] = static_cast<int8_t>(mul * __ldg(src + j) - sub);
    }
  }
  // the K padding: the weights are zero there, the bytes must only exist
}

// A block of 8 or 16 warps (the launcher's choice) walks its tiles in step.
// Within 128 registers a thread either way. The weight column chunks are
// spread over the grid's second axis where the launcher gave it one (few
// tiles, many chunks), else a block passes over its tiles once per chunk.
// WIDE: the 15-threshold epilogue of 4-bit codes (mma_tile.cuh). kConvPool
// stores no codes through the staging buffers, so it has none.
template <int OUT, bool WIDE>
__global__ void __launch_bounds__(2 * kThreads, 1)
conv_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int cols_pad = round_up(a.n_chunk, kItemCols);
  // rows of staged int32 a column: the thresholds, or the accumulator's
  // correction
  const int thr_rows = OUT == kConvAcc ? 1 : a.ep.nthr;

  int8_t* wsm = smem;
  int32_t* const thr_s = reinterpret_cast<int32_t*>(
      smem + static_cast<size_t>(a.n_chunk) * a.w_pitch);
  int8_t* const stages =
      reinterpret_cast<int8_t*>(thr_s + thr_words<WIDE>(thr_rows, cols_pad));
  constexpr int kStage = OUT == kConvPool ? 0 : kStageBytes;
  int8_t* const stage = stages + warp * kStage;
  // patch rows, two input-row buffers, and the byte offset of each tile
  // pixel's first tap within the activation buffer
  int8_t* const patches = stages + nwarps * kStage;
  int8_t* const rows0 = patches + a.patch_bytes;
  int8_t* const rows1 = rows0 + a.rows_bytes;
  int* const pix_off = reinterpret_cast<int*>(rows0 + 2 * a.rows_bytes);

  const int ntiles = (a.pixels + a.tile - 1) / a.tile;
  const int tile_step = gridDim.x;
  const int kvec = a.k32 / kVec;
  const bool halo = a.halo;
  EpilogueArgs ep = a.ep;
  ep.codes_in = halo && !a.input_levels;

  // the mma loop's view of the A tile: taps × (c_eff / 32) steps
  const int ks = halo ? a.ksize : 1;
  const int c_eff = halo ? a.c : a.k32;
  const int pix_pitch = a.a_pitch;

  for (int nc0 = blockIdx.y * a.n_chunk; nc0 < ep.n_out;
       nc0 += gridDim.y * a.n_chunk) {
    const int ncols = min(a.n_chunk, ep.n_out - nc0);
    __syncthreads();   // the last pass's reads of shared memory are done
    if constexpr (OUT == kConvAcc) {
      stage_acc_correction(thr_s, cols_pad, ep, nc0, ncols);
    } else {
      stage_thresholds<WIDE>(thr_s, cols_pad, ep, nc0, ncols);
    }
    {
      const unsigned dst = smem_addr(wsm);
      const int8_t* src = a.wt + static_cast<size_t>(nc0) * a.k32;
      for (int i = threadIdx.x; i < ncols * kvec; i += blockDim.x) {
        const int n = i / kvec;
        const int v = i - n * kvec;
        cp_async16(dst + n * a.w_pitch + v * kVec,
                   src + static_cast<size_t>(i) * kVec);
      }
    }
    int tile = blockIdx.x;
    int cur = 0;
    if (halo && tile < ntiles) {
      const int p0 = tile * a.tile;
      copy_rows_async<OUT>(a, p0, min(p0 + a.tile, a.pixels) - 1, rows0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();   // weights, thresholds and the first rows are there

    for (; tile < ntiles; tile += tile_step) {
      const int p0 = tile * a.tile;
      const int p1 = min(p0 + a.tile, a.pixels) - 1;
      const int8_t* rows_cur = cur ? rows1 : rows0;
      if (halo) {
        const int next = tile + tile_step;
        if (next < ntiles) {
          const int q0 = next * a.tile;
          copy_rows_async<OUT>(a, q0, min(q0 + a.tile, a.pixels) - 1,
                               cur ? rows0 : rows1);
        }
        cp_async_commit();
        cp_async_wait<1>();   // all but the copy just started have landed
      } else {
        gather_patches<OUT>(a, p0, p1, patches);
      }
      {
        const int first_row = halo ? input_row_of<OUT>(a, p0) : 0;
        for (int m = threadIdx.x; m <= p1 - p0; m += blockDim.x) {
          const int p = p0 + m;
          pix_off[m] = halo ? ((input_row_of<OUT>(a, p) - first_row) * a.w +
                               column_of<OUT>(a, p)) *
                                  pix_pitch
                            : m * pix_pitch;
        }
      }
      __syncthreads();

      const int8_t* at = halo ? rows_cur : patches;
      const int m_items = (p1 - p0 + kItemRows) / kItemRows;
      const int n_items = (ncols + kItemCols - 1) / kItemCols;
      for (int item = warp; item < m_items * n_items; item += nwarps) {
        const int mi = item % m_items;
        const int ni = item / m_items;
        const int m0 = mi * kItemRows;
        const int n0 = ni * kItemCols;        // within the staged chunk
        const int cols = min(kItemCols, ncols - n0);

        unsigned a_addr[2], b_addr[4];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          // rows past the ragged edge read the last real pixel's data
          const int m = min(m0 + 16 * mb + a_lane_row(lane), p1 - p0);
          a_addr[mb] = smem_addr(at) + pix_off[m] + a_lane_k(lane);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const int n = min(n0 + 16 * jp + b_lane_col(lane), ncols - 1);
          b_addr[jp] = smem_addr(wsm) + n * a.w_pitch + b_lane_k(lane);
        }

        ItemAcc acc;
        item_clear(acc);
        const int steps = c_eff / kMmaK;
        unsigned koff = 0;
        for (int ki = 0; ki < ks; ++ki) {
          for (int kj = 0; kj < ks; ++kj) {
            const unsigned tap = (ki * a.w + kj) * pix_pitch;
            const unsigned aa[2] = {a_addr[0] + tap, a_addr[1] + tap};
            const unsigned bb[4] = {b_addr[0] + koff, b_addr[1] + koff,
                                    b_addr[2] + koff, b_addr[3] + koff};
            item_mma(acc, aa, bb, steps, cols);
            koff += c_eff;
          }
        }

        const int col0 = nc0 + n0;
        const size_t row0 = static_cast<size_t>(p0 + m0);
        const int rows = min(kItemRows, p1 - p0 + 1 - m0);
        if constexpr (OUT == kConvAcc) {
          item_store_acc(acc, thr_s + n0, ep.codes_in ? 2 : 1,
                         static_cast<int32_t*>(a.out), ep.n_out, row0, rows,
                         col0, cols, a.out_vec, lane);
        } else if constexpr (OUT == kConvPool) {
          // a tile starts on a window, and its pixels fill whole windows
          item_store_pooled<WIDE>(acc, thr_s + n0, cols_pad, ep.nthr,
                                  static_cast<int8_t*>(a.out), ep.n_out,
                                  row0 / 4, rows / 4, col0, cols, a.out_vec,
                                  lane);
        } else {
          item_store_codes<8, WIDE>(
              acc, thr_s + n0, cols_pad, ep.nthr, stage,
              static_cast<int8_t*>(a.out), ep.n_out, row0, rows, col0, cols,
              a.out_vec && col0 % kVec == 0 && cols % kVec == 0, lane);
        }
      }
      __syncthreads();   // the buffers are free for the next tile
      if (halo) cur ^= 1;
    }
    cp_async_wait<0>();
  }
}

// Upper bound of the input rows a tile needs, over all tiles of `tile`
// pixels. pool: the tile holds tile / 4 pooled pixels of the [oh/2, ow/2]
// grid, and a pooled row covers two output rows.
inline int max_tile_rows(int tile, int oh, int ow, int ksize,
                         bool pool = false) {
  const int f = pool ? 2 : 1;
  const int cells = tile / (f * f);
  const int out_rows = (cells - 1) / (ow / f) + 2;
  const int images = (cells - 1) / ((oh / f) * (ow / f)) + 2;
  return f * out_rows + images * (ksize - 1);
}

// Validate, size the tile and launch one conv layer.
//   x: int8 [b, h, w, c] codes (levels if input_levels); wt: int8 [n_out, k32]
//   with k32 = round_up(ksize²·c, 32), zero past K; wsum: int32 [n_out], the
//   column sums of wt; kConvCodes: thr int32 [nthr, n_out], out int8
//   [b, h-ksize+1, w-ksize+1, n_out]; kConvAcc: no thresholds, out int32;
//   kConvPool: thr as kConvCodes, out int8 [b, oh/2, ow/2, n_out] for the
//   output's oh × ow, both even (an odd map is refused, not cut).
template <int OUT>
int launch_conv(const void* x, int b, int h, int w, int c, int ksize,
                int input_levels, const void* wt, int k32, int n_out,
                const void* wsum, const void* thr, int nthr, int abits,
                void* out, cudaStream_t stream) {
  if (b < 0 || c < 1 || ksize < 1 || h < ksize || w < ksize || n_out < 1 ||
      !abits_ok(abits) || k32 != round_up(ksize * ksize * c, kMmaK)) {
    return cudaErrorInvalidValue;
  }
  if (OUT == kConvAcc ? nthr != 0 : !nthr_ok(nthr)) {
    return cudaErrorInvalidValue;
  }
  const int oh = h - ksize + 1;
  const int ow = w - ksize + 1;
  if (OUT == kConvPool && (oh % 2 != 0 || ow % 2 != 0)) {
    return cudaErrorInvalidValue;
  }
  const long long pixels = static_cast<long long>(b) * oh * ow;
  if (pixels > 0x7fffffffLL || static_cast<long long>(b) * h > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (pixels == 0) return cudaSuccess;

  ConvArgs a = {};
  a.x = static_cast<const int8_t*>(x);
  a.h = h;
  a.w = w;
  a.c = c;
  a.ksize = ksize;
  a.input_levels = input_levels;
  a.wt = static_cast<const int8_t*>(wt);
  a.k32 = k32;
  a.out = out;
  a.oh = oh;
  a.ow = ow;
  a.pixels = static_cast<int>(pixels);
  a.halo = c % kMmaK == 0 && reinterpret_cast<uintptr_t>(x) % kVec == 0;
  a.a_pitch = padded_pitch(a.halo ? c : k32);
  a.w_pitch = padded_pitch(k32);
  a.ep.thr = static_cast<const int32_t*>(thr);
  a.ep.wsum = static_cast<const int32_t*>(wsum);
  a.ep.nthr = nthr;
  a.ep.n_out = n_out;
  a.ep.level_off = level_off(abits);
  const uintptr_t out_at = reinterpret_cast<uintptr_t>(out);
  a.out_vec = OUT == kConvCodes  ? n_out % kVec == 0 && out_at % kVec == 0
              : OUT == kConvPool ? n_out % 2 == 0 && out_at % 2 == 0
                                 : n_out % 2 == 0 && out_at % 8 == 0;
  const int thr_rows = OUT == kConvAcc ? 1 : nthr;

  // A tile has an item for each warp. Size a block of 8 warps: halve the
  // staged weight columns while they alone take more than two thirds of
  // shared memory (a tile of one item would be left beside them), then
  // shrink the tile, then the columns again, until it fits. Where a second
  // such block would not fit beside it, take 16 warps on twice the tile if
  // that fits. kConvPool's epilogue has no staging buffers.
  int warps = kWarps;
  a.tile = n_out <= kItemCols ? 256 : 128;
  a.n_chunk = round_up(n_out, 8);
  while (a.n_chunk > 8 && static_cast<size_t>(a.n_chunk) * a.w_pitch >
                              static_cast<size_t>(kMaxSmem) / 3 * 2) {
    a.n_chunk = round_up(a.n_chunk / 2, 8);
  }
  const auto smem_of = [&](int tile, int nwarps) {
    const size_t span =
        static_cast<size_t>(
            max_tile_rows(tile, oh, ow, ksize, OUT == kConvPool)) *
        w;
    a.rows_bytes = a.halo ? static_cast<int>(span * a.a_pitch) : 0;
    a.patch_bytes = a.halo ? 0 : tile * a.a_pitch;
    return static_cast<size_t>(a.n_chunk) * a.w_pitch +
           epilogue_smem(thr_rows, a.n_chunk,
                         OUT == kConvPool ? 0 : nwarps) +
           a.patch_bytes +
           2 * static_cast<size_t>(a.rows_bytes) + tile * sizeof(int);
  };
  size_t smem = 0;
  while ((smem = smem_of(a.tile, warps)) > static_cast<size_t>(kMaxSmem)) {
    if (a.tile > kItemRows) {
      a.tile /= 2;
    } else if (a.n_chunk > 8) {
      a.n_chunk = round_up(a.n_chunk / 2, 8);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (2 * (smem + kReservedSmem) > static_cast<size_t>(kSmemPerSm) &&
      smem_of(2 * a.tile, 2 * kWarps) <= static_cast<size_t>(kMaxSmem)) {
    warps = 2 * kWarps;
    a.tile *= 2;
  }
  smem = smem_of(a.tile, warps);   // also sets the buffer sizes in `a`
  const int threads = 32 * warps;

  auto kernel = conv_kernel<OUT, false>;
  if constexpr (OUT != kConvAcc) {
    if (nthr == kMaxThr) kernel = conv_kernel<OUT, true>;
  }
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, resident = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &resident, kernel, threads, smem)) != cudaSuccess) {
    return err;
  }
  if (resident < 1) return cudaErrorInvalidValue;
  const long long ntiles = (pixels + a.tile - 1) / a.tile;
  const long long room = static_cast<long long>(sms) * resident;
  // the column chunks on the grid's second axis while every (tile, chunk)
  // pair has a block of its own: each block then stages one chunk, once
  const int chunks = (n_out + a.n_chunk - 1) / a.n_chunk;
  const int grid_y = ntiles * chunks <= room ? chunks : 1;
  const dim3 grid(static_cast<unsigned>(ntiles < room ? ntiles : room), grid_y);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bnn
