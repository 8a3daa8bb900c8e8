// One stride-1 VALID K×K quantized conv with the MultiThreshold fused:
// NHWC int8 codes (or raw int8 levels) in, int8 codes of the valid region
// [B, H-K+1, W-K+1, N] out. The wrapper (ops/conv_stack.py::conv_chain)
// launches it once per layer of a chain; the intermediate codes go through
// device memory.
//
// Replaces bnn_pynq_tpu/ops/conv_stack.py::conv_chain_vmem (CNV's
// conv0+conv1 and conv2+conv3 chains). The JAX kernel returns the full
// pitch grid with garbage borders and needs the first conv's patches built
// outside it (im2col0); this kernel writes only the valid region and reads
// the raw 3-channel image itself, so that glue stage is gone.
//
// What bounds it on the H100: operations. CNV-W1A1 at batch 1024 is 114
// G int8 operations over the four layers (0.058 ms at the card's 1,979
// TOP/s) against 80 MB of input and output (0.024 ms at 3.35 TB/s). What
// the design does about it:
// - the dots run on the int8 tensor cores (mma.sync m16n8k32, mma_tile.cuh),
//   int32 accumulation, exact;
// - a block is persistent (grid = SMs × resident blocks) and stages the
//   layer's whole weight set in shared memory once, with cp.async, in the
//   [N, K] layout the B fragments are read in (2 to 146 KB for CNV's four
//   layers), then loops over output tiles. Weights that do not fit beside
//   the activations are staged in column chunks, one pass over the tiles
//   per chunk;
// - an output tile is a run of consecutive output pixels of the flattened
//   [B·OH·OW] grid. The input rows it needs (its output rows plus K−1 halo
//   rows per image touched) are one contiguous span of the input, copied
//   once, as raw codes, by cp.async into a shared-memory tile; the A
//   fragment of tap (ki, kj) is read from that tile at a shifted offset
//   (implicit GEMM, C % 32 == 0). The next tile's rows are copied into a
//   second buffer behind the current tile's mma;
// - any other C (the 3-channel image, C = 24) gathers a K²·C patch row per
//   pixel into shared memory as levels, byte by byte, and runs the same
//   mma loop over it (K padded to 32: 32 bytes a pixel for conv0). Staging
//   the image rows by cp.async first and building the patches from shared
//   memory was tried and was no faster: the byte-wise build is the cost;
// - a warp owns an item of 32 pixels × 64 channels of accumulators (a tile
//   has an item for each warp of the block) and thresholds them in
//   registers against thresholds staged in shared memory; the codes leave
//   through a per-warp staging buffer as 16-byte stores, 64 contiguous
//   bytes a pixel; the ragged last tile is masked at the store;
// - an SM holds 16 warps: two blocks of 8 or, where shared memory has no
//   room for the weights twice, one block of 16 on a tile twice as large.
//   (Two halves of a block walking tiles of their own behind a named
//   barrier each were tried in place of the 16 warps in step: as fast, with
//   more code and spilled registers, so taken out.)
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, CNV-W1A1, batch
// 1024): 0.32 ms per forward over the four layers, 0.30 under CUDA graph
// replay, against 2.35 ms for the dp4a kernel this replaces (one thread per
// channel and 8 pixels, weights streamed from L2). conv1-3 reach 439-538
// TOP/s, 35-43 % of what mma.sync reaches alone on this card
// (tools/layer_times.py); conv0 is bound by its patch gather. PERF.md §6.
#include "mma_tile.cuh"

namespace bnn {
namespace {

struct ConvArgs {
  const int8_t* x;     // [b, h, w, c]
  int h, w, c;
  int ksize;
  int input_levels;
  const int8_t* wt;    // [n_out, k32] levels, (ki, kj, c) order, zero past K
  int k32;
  int8_t* out;         // [b, oh, ow, n_out] codes
  int oh, ow;
  int pixels;          // b * oh * ow
  int tile;            // output pixels per tile, a multiple of kItemRows
  int n_chunk;         // weight columns staged at once
  int halo;            // 1: input rows staged, the mma reads them in place;
                       // 0: a patch row per pixel gathered from device memory
  int a_pitch;         // halo: bytes per staged pixel; else: per patch row
  int patch_bytes;     // bytes of the patch buffer (0 with halo)
  int rows_bytes;      // bytes of one input-row buffer (0 without)
  int w_pitch;         // bytes per staged weight row
  int out_vec;         // out is 16-byte aligned and n_out % 16 == 0
  EpilogueArgs ep;
};

// The first input row (of the flattened [b·h] row space) under output pixel
// p. The rows that pixels [p0, p1] need are input_row_of(p0) ..
// input_row_of(p1) + ksize − 1: contiguous in memory, images included.
__device__ __forceinline__ int input_row_of(const ConvArgs& a, int p) {
  const int q = p / a.ow;               // flattened output row
  return (q / a.oh) * a.h + q % a.oh;
}

// Start the copy of the input rows of pixels [p0, p1] into `buf`, each
// pixel's c bytes pitched to a_pitch.
__device__ __forceinline__ void copy_rows_async(const ConvArgs& a, int p0,
                                                int p1, int8_t* buf) {
  const int first = input_row_of(a, p0);
  const int count = input_row_of(a, p1) + a.ksize - first;
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
__device__ __forceinline__ void gather_patches(const ConvArgs& a, int p0,
                                               int p1, int8_t* buf) {
  const int run = a.ksize * a.c;
  const int parts = blockDim.x / a.tile;
  const int tid = threadIdx.x;
  const int r = tid % a.tile;
  if (p0 + r > p1) return;
  const int p = p0 + r;
  const size_t row0 = input_row_of(a, p);
  const int sub = a.input_levels ? 0 : a.ep.level_off;
  const int mul = a.input_levels ? 1 : 2;
  for (int ki = tid / a.tile; ki < a.ksize; ki += parts) {
    const int8_t* src = a.x + ((row0 + ki) * a.w + p % a.ow) * a.c;
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
// Within 128 registers a thread either way.
__global__ void __launch_bounds__(2 * kThreads, 1)
conv_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int cols_pad = round_up(a.n_chunk, kItemCols);

  int8_t* wsm = smem;
  int32_t* const thr_s = reinterpret_cast<int32_t*>(
      smem + static_cast<size_t>(a.n_chunk) * a.w_pitch);
  int8_t* const stages = reinterpret_cast<int8_t*>(thr_s + a.ep.nthr * cols_pad);
  int8_t* const stage = stages + warp * kStageBytes;
  // patch rows, two input-row buffers, and the byte offset of each tile
  // pixel's first tap within the activation buffer
  int8_t* const patches = stages + nwarps * kStageBytes;
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

  for (int nc0 = 0; nc0 < ep.n_out; nc0 += a.n_chunk) {
    const int ncols = min(a.n_chunk, ep.n_out - nc0);
    __syncthreads();   // the last pass's reads of shared memory are done
    stage_thresholds(thr_s, cols_pad, ep, nc0, ncols);
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
      copy_rows_async(a, p0, min(p0 + a.tile, a.pixels) - 1, rows0);
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
          copy_rows_async(a, q0, min(q0 + a.tile, a.pixels) - 1,
                          cur ? rows0 : rows1);
        }
        cp_async_commit();
        cp_async_wait<1>();   // all but the copy just started have landed
      } else {
        gather_patches(a, p0, p1, patches);
      }
      {
        const int first_row = halo ? input_row_of(a, p0) : 0;
        for (int m = threadIdx.x; m <= p1 - p0; m += blockDim.x) {
          const int p = p0 + m;
          pix_off[m] =
              halo ? ((input_row_of(a, p) - first_row) * a.w + p % a.ow) *
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
        item_store_codes(acc, thr_s + n0, cols_pad, ep.nthr, stage, a.out,
                         ep.n_out, static_cast<size_t>(p0 + m0),
                         min(kItemRows, p1 - p0 + 1 - m0), col0, cols,
                         a.out_vec && col0 % kVec == 0 && cols % kVec == 0,
                         lane);
      }
      __syncthreads();   // the buffers are free for the next tile
      if (halo) cur ^= 1;
    }
    cp_async_wait<0>();
  }
}

// Upper bound of the input rows a tile needs, over all tiles of `tile` pixels.
int max_tile_rows(int tile, int oh, int ow, int ksize) {
  const int out_rows = (tile - 1) / ow + 2;
  const int images = (tile - 1) / (oh * ow) + 2;
  return out_rows + images * (ksize - 1);
}

}  // namespace
}  // namespace bnn

extern "C" {

// x: int8 [b, h, w, c] codes (levels if input_levels); wt: int8 [n_out, k32]
// with k32 = round_up(ksize²·c, 32), zero past K; wsum: int32 [n_out], the
// column sums of wt; thr: int32 [nthr, n_out];
// out: int8 [b, h-ksize+1, w-ksize+1, n_out].
int bnn_conv_layer(const void* x, int b, int h, int w, int c, int ksize,
                   int input_levels, const void* wt, int k32, int n_out,
                   const void* wsum, const void* thr, int nthr, int abits,
                   void* out, void* stream) {
  using namespace bnn;
  if (b < 0 || c < 1 || ksize < 1 || h < ksize || w < ksize || n_out < 1 ||
      nthr < 1 || nthr > kMaxThr || (abits != 1 && abits != 2) ||
      k32 != round_up(ksize * ksize * c, kMmaK)) {
    return cudaErrorInvalidValue;
  }
  const int oh = h - ksize + 1;
  const int ow = w - ksize + 1;
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
  a.out = static_cast<int8_t*>(out);
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
  a.ep.level_off = abits == 1 ? 1 : 3;
  a.out_vec = n_out % kVec == 0 && reinterpret_cast<uintptr_t>(out) % kVec == 0;

  // A tile has an item for each warp. Size a block of 8 warps: shrink the
  // tile, then the staged weight columns, until it fits. Where a second such
  // block would not fit beside it, take 16 warps on twice the tile if that
  // fits.
  int warps = kWarps;
  a.tile = n_out <= kItemCols ? 256 : 128;
  a.n_chunk = round_up(n_out, 8);
  const auto smem_of = [&](int tile, int nwarps) {
    const size_t span =
        static_cast<size_t>(max_tile_rows(tile, oh, ow, ksize)) * w;
    a.rows_bytes = a.halo ? static_cast<int>(span * a.a_pitch) : 0;
    a.patch_bytes = a.halo ? 0 : tile * a.a_pitch;
    return static_cast<size_t>(a.n_chunk) * a.w_pitch +
           epilogue_smem(nthr, a.n_chunk, nwarps) + a.patch_bytes +
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
  if (2 * smem > static_cast<size_t>(kMaxSmem) &&
      smem_of(2 * a.tile, 2 * kWarps) <= static_cast<size_t>(kMaxSmem)) {
    warps = 2 * kWarps;
    a.tile *= 2;
  }
  smem = smem_of(a.tile, warps);   // also sets the buffer sizes in `a`
  const int threads = 32 * warps;

  cudaError_t err = allow_smem(conv_kernel, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, resident = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &resident, conv_kernel, threads, smem)) != cudaSuccess) {
    return err;
  }
  if (resident < 1) return cudaErrorInvalidValue;
  const long long ntiles = (pixels + a.tile - 1) / a.tile;
  const long long grid = static_cast<long long>(sms) * resident;
  conv_kernel<<<static_cast<int>(ntiles < grid ? ntiles : grid), threads, smem,
                static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
