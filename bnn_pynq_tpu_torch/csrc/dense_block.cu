// One thresholded quantized dense layer: int8 codes (or levels) [M, K] in,
// int8 codes [M, N] out. The wrapper (ops/conv_stack.py::dense_block)
// launches it once per layer of a block; a block of several layers passes
// its intermediate codes through device memory (an int8 buffer of the
// wrapper's), which at these sizes costs less than the weights' traffic.
//
// Replaces bnn_pynq_tpu/ops/conv_stack.py::dense_block (CNV's conv5 on B·9
// im2col rows). Entry point: bnn_dense_block. (bnn_fused_mlp, the whole-MLP
// kernel, stays in dense_chain.cu.) A second entry, bnn_dense_residual
// (ops/conv_stack.py::dense_residual), runs ResNet-50's block-closing 1×1
// convs: the same kernel with its residual template argument RES set, so
// that the bottleneck block's shortcut joins the accumulator before the
// thresholds, y = MT(c + r ⊙ p), and no int32 map goes through memory:
// - kResIdentity: p = x, the block input's unsigned codes [m, n_out]; the
//   epilogue adds r[n]·x[m, n] to each accumulator (item_add_residual);
// - kResProjection: p = x_s · W_p, the 1×1 projection of the block input
//   at the block's stride; the weights are [W_c ; W_p·diag(r)] (int8, as
//   |r| ≤ 127), and the K loop runs on past the rows' k0 bytes into the
//   block input's codes at the strided pixel of each row, so both products
//   fall into one accumulator. A 16-byte K chunk comes wholly from one
//   source where k0 and the input's channels are multiples of 16.
// Both take unsigned codes (their own levels) and 1-3 thresholds; the
// instantiations without a shortcut (RES = kResNone) are CNV's and
// MobileNet's, and take DenseArgs alone, so that their code is what it was.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; ResNet-50 v1.5 W1A2 at batch
// 256 under graph replay in its benchmark cell): the 12 identity junctions
// 3.21 ms a forward, the 4 projection junctions 1.05, against 0.92 ms by
// the larger of operations and bytes for each (PERF.md §6).
//
// What bounds it on the H100: bytes. CNV's block6 at batch 1024 is
// M = 9216, K = 1152, N = 256: 13.3 MB in and out (0.004 ms at 3.35 TB/s)
// against 5.4 G int8 operations (0.003 ms at 1,979 TOP/s). What the design
// does about it:
// - a GEMM with an epilogue on the int8 tensor cores (mma.sync m16n8k32,
//   mma_tile.cuh): a block owns 64 rows × up to 256 columns (fewer columns,
//   more rows: 8 warps of 32 × 64 accumulators each), so the 295 KB of
//   weights are fetched once per 64 rows, from L2;
// - K is the pipelined dimension: 64-byte K slices of the rows and of the
//   weights go through a 3-stage cp.async ring in shared memory (25.6 KB a
//   stage, 2 blocks an SM), the accumulators stay in registers;
// - codes are copied raw and the thresholds folded to match (mma_tile.cuh);
//   the output codes leave as 16-byte stores through a staging buffer;
// - MobileNet's 1×1 convs run here on B·H·W rows of unsigned 4-bit codes,
//   which are their own levels (no correction) and take 15 thresholds,
//   sorted on the host and searched in 4 compares (mma_tile.cuh);
// - rows whose width is not a multiple of 16 bytes are staged by byte loads;
//   N above 256 runs as column chunks on the grid's second axis; the ragged
//   last rows are masked at the store.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, block6 at batch
// 1024): 0.026 ms under CUDA graph replay (0.046 between CUDA events, which
// read the wrapper's host enqueue at this size), against 0.206 ms for the
// dp4a chain kernel it replaces (8 rows a block, the whole weight matrix
// streamed from L2 by each). What is left: 144 blocks on 132 SMs, and every
// block re-reads the weights from L2. MobileNet-v1 W4A4's 13 1×1 convs at
// batch 256 (chip_smoke.py phase 24): 1.52 ms under graph replay, 2.73
// with each of the 15 thresholds compared, against 0.362 ms by bytes. What
// is left there: at K = 32-128 (0.61 of the 1.52 ms) a block's life is one
// to four k32 steps between its prologue and an epilogue of some 18
// instructions a code; at K = 512 each 64-row block re-reads 128 KB of
// weights from L2. PERF.md §6-§7.
#include "mma_tile.cuh"

namespace bnn {
namespace {

constexpr int kSlice = 64;                        // bytes of K per stage
constexpr int kSlicePitch = kSlice + kPitchPad;   // 80 ≡ 16 (mod 32)
constexpr int kStages = 3;
constexpr int kMaxCols = 4 * kItemCols;           // columns of a block

enum Residual : int { kResNone = 0, kResIdentity = 1, kResProjection = 2 };

struct DenseArgs {
  const int8_t* x;     // [m, k0]
  int m, k0;
  int vec_rows;        // rows of x are 16-byte vectors (k0 % 16 == 0, aligned)
                       // (kResProjection: and so are the input's pixels)
  const int8_t* wt;    // [n_out, k32] levels, zero past k0 (+ c2)
  int k32;
  int8_t* out;         // [m, n_out] codes
  int col_warps;       // 1, 2 or 4 warps across the columns
  int out_vec;         // out is 16-byte aligned and n_out % 16 == 0
  EpilogueArgs ep;
};

// What dense_kernel<WIDE, RES> takes (ArgsOf<RES>::type). With a shortcut
// (RES != kResNone), DenseArgs and the block input [b, h2, w2, c2] codes:
// row m of x and out is pixel (oy, ox) of image m / (oh·ow), whose shortcut
// reads input pixel (oy·stride, ox·stride). Without, DenseArgs itself: the
// kernels without a shortcut then compile to the code they did (a larger
// parameter block, or DenseArgs as a base, changes ptxas' schedule).
struct Shortcut {
  const int8_t* x2;
  int h2, w2, c2, stride, oh, ow;
  const int32_t* r;    // kResIdentity: [n_out], the shortcut's multiplier
  int res_pairs;       // kResIdentity: n_out even and x2 2-byte aligned
};
struct ResidualArgs : DenseArgs {
  Shortcut sc;
};
template <int RES>
struct ArgsOf {
  using type = ResidualArgs;
};
template <>
struct ArgsOf<kResNone> {
  using type = DenseArgs;
};

// The input pixel (flattened [b·h2·w2]) whose codes row `row` adds.
__device__ __forceinline__ size_t shortcut_pixel(const Shortcut& a, int row) {
  if (a.stride == 1) return static_cast<size_t>(row);
  const int q = row / a.ow;              // flattened output row
  const int ox = row - q * a.ow;
  const int img = q / a.oh;
  const int oy = q - img * a.oh;
  return (static_cast<size_t>(img) * a.h2 + oy * a.stride) * a.w2 +
         static_cast<size_t>(ox) * a.stride;
}

// WIDE: the 15-threshold epilogue of 4-bit codes (mma_tile.cuh); RES: the
// shortcut (kResNone: none).
template <bool WIDE, int RES>
__global__ void __launch_bounds__(kThreads, 2)
dense_kernel(const typename ArgsOf<RES>::type a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row_warps = kWarps / a.col_warps;
  const int tile_rows = row_warps * kItemRows;
  const int tile_cols = a.col_warps * kItemCols;
  const int stage_bytes = (tile_rows + tile_cols) * kSlicePitch;
  int32_t* const thr_s =
      reinterpret_cast<int32_t*>(smem + kStages * stage_bytes);
  int8_t* const stage =
      reinterpret_cast<int8_t*>(thr_s + thr_words<WIDE>(a.ep.nthr, tile_cols)) +
      warp * kStageBytes;
  const int row0 = blockIdx.x * tile_rows;
  const int nc0 = blockIdx.y * kMaxCols;
  const int ncols = min(tile_cols, a.ep.n_out - nc0);
  const int nslices = (a.k32 + kSlice - 1) / kSlice;

  auto load_slice = [&](int s) {
    int8_t* as = smem + (s % kStages) * stage_bytes;
    int8_t* bs = as + tile_rows * kSlicePitch;
    const int k = s * kSlice;
    constexpr int kv = kSlice / kVec;
    if (a.vec_rows) {
      for (int i = threadIdx.x; i < tile_rows * kv; i += blockDim.x) {
        const int r = i / kv;
        const int kb = k + (i % kv) * kVec;
        // past the ragged edge: the last real row; past k0: zero weights
        const int row = min(row0 + r, a.m - 1);
        if (kb < a.k0) {
          cp_async16(smem_addr(as + r * kSlicePitch + (kb - k)),
                     a.x + static_cast<size_t>(row) * a.k0 + kb);
        } else if constexpr (RES == kResProjection) {
          if (kb < a.k0 + a.sc.c2) {
            cp_async16(smem_addr(as + r * kSlicePitch + (kb - k)),
                       a.sc.x2 + shortcut_pixel(a.sc, row) * a.sc.c2 +
                           (kb - a.k0));
          }
        }
      }
    } else {
      for (int i = threadIdx.x; i < tile_rows * kSlice; i += blockDim.x) {
        const int r = i / kSlice;
        const int kb = k + i % kSlice;
        const int row = min(row0 + r, a.m - 1);
        if (kb < a.k0) {
          as[r * kSlicePitch + (kb - k)] =
              __ldg(a.x + static_cast<size_t>(row) * a.k0 + kb);
        } else if constexpr (RES == kResProjection) {
          if (kb < a.k0 + a.sc.c2) {
            as[r * kSlicePitch + (kb - k)] = __ldg(
                a.sc.x2 + shortcut_pixel(a.sc, row) * a.sc.c2 + (kb - a.k0));
          }
        }
      }
    }
    for (int i = threadIdx.x; i < ncols * kv; i += blockDim.x) {
      const int n = i / kv;
      const int kb = k + (i % kv) * kVec;
      if (kb < a.k32) {
        cp_async16(smem_addr(bs + n * kSlicePitch + (kb - k)),
                   a.wt + static_cast<size_t>(nc0 + n) * a.k32 + kb);
      }
    }
  };

  const int mi = warp % row_warps;
  const int n0 = (warp / row_warps) * kItemCols;
  const bool active = n0 < ncols;
  const int cols = min(kItemCols, ncols - n0);
  unsigned a_off[2], b_off[4];    // the lane's offsets within a stage
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    a_off[mb] = (mi * kItemRows + 16 * mb + a_lane_row(lane)) * kSlicePitch +
                a_lane_k(lane);
  }
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    const int n = max(min(n0 + 16 * jp + b_lane_col(lane), ncols - 1), 0);
    b_off[jp] = (tile_rows + n) * kSlicePitch + b_lane_k(lane);
  }

  ItemAcc acc;
  item_clear(acc);
  // read after the loop
  stage_thresholds<WIDE>(thr_s, tile_cols, a.ep, nc0, ncols);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslices) load_slice(s);
    cp_async_commit();
  }
  for (int s = 0; s < nslices; ++s) {
    cp_async_wait<kStages - 2>();   // slice s has landed
    __syncthreads();                // ... for everyone; slice s−1 is consumed
    if (s + kStages - 1 < nslices) load_slice(s + kStages - 1);
    cp_async_commit();
    if (active) {
      const unsigned base = smem_addr(smem + (s % kStages) * stage_bytes);
      const unsigned aa[2] = {base + a_off[0], base + a_off[1]};
      const unsigned bb[4] = {base + b_off[0], base + b_off[1],
                              base + b_off[2], base + b_off[3]};
      item_mma(acc, aa, bb, min(kSlice, a.k32 - s * kSlice) / kMmaK, cols);
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  const int col0 = nc0 + n0;
  if constexpr (RES == kResIdentity) {
    item_add_residual(acc, a.sc.x2, a.sc.r, a.ep.n_out,
                      static_cast<size_t>(row0 + mi * kItemRows),
                      min(kItemRows, a.m - row0 - mi * kItemRows), col0, cols,
                      a.sc.res_pairs, lane);
  }
  item_store_codes<8, WIDE>(
      acc, thr_s + n0, tile_cols, a.ep.nthr, stage, a.out, a.ep.n_out,
      static_cast<size_t>(row0 + mi * kItemRows),
      min(kItemRows, a.m - row0 - mi * kItemRows), col0, cols,
      a.out_vec && cols % kVec == 0, lane);
}

// Fill the launch geometry of `a` (x, m, k0, wt, k32, n_out, the epilogue's
// thresholds and sums set) and launch dense_kernel<WIDE, RES>.
template <int RES>
int launch_dense(typename ArgsOf<RES>::type a, const void* out,
                 cudaStream_t stream) {
  a.vec_rows = a.k0 % kVec == 0 &&
               reinterpret_cast<uintptr_t>(a.x) % kVec == 0;
  if constexpr (RES == kResProjection) {
    a.vec_rows = a.vec_rows && a.sc.c2 % kVec == 0 &&
                 reinterpret_cast<uintptr_t>(a.sc.x2) % kVec == 0;
  }
  a.out = static_cast<int8_t*>(const_cast<void*>(out));
  a.col_warps = a.ep.n_out <= kItemCols ? 1 : a.ep.n_out <= 2 * kItemCols ? 2 : 4;
  a.out_vec = a.ep.n_out % kVec == 0 &&
              reinterpret_cast<uintptr_t>(out) % kVec == 0;

  const int tile_rows = kWarps / a.col_warps * kItemRows;
  const int tile_cols = a.col_warps * kItemCols;
  const size_t smem =
      static_cast<size_t>(kStages) * (tile_rows + tile_cols) * kSlicePitch +
      epilogue_smem(a.ep.nthr, tile_cols);
  // the residual epilogue takes 1-3 thresholds: no wide instantiation
  constexpr bool kWide = RES == kResNone;
  const auto kernel = kWide && a.ep.nthr == kMaxThr ? dense_kernel<kWide, RES>
                                                     : dense_kernel<false, RES>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.m + tile_rows - 1) / tile_rows,
                  (a.ep.n_out + kMaxCols - 1) / kMaxCols);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bnn

extern "C" {

// x: int8 [m, k0] codes (levels if input_levels); wt: int8 [n_out, k32] with
// k32 = round_up(k0, 32), zero past k0; wsum: int32 [n_out], the column sums
// of wt; thr: int32 [nthr, n_out]; out: int8 [m, n_out] codes.
int bnn_dense_block(const void* x, int m, int k0, int input_levels,
                    const void* wt, int k32, int n_out, const void* wsum,
                    const void* thr, int nthr, int abits, void* out,
                    void* stream) {
  using namespace bnn;
  if (m < 0 || k0 < 1 || n_out < 1 || !nthr_ok(nthr) || !abits_ok(abits) ||
      k32 != round_up(k0, kMmaK)) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;

  DenseArgs a = {};
  a.x = static_cast<const int8_t*>(x);
  a.m = m;
  a.k0 = k0;
  a.wt = static_cast<const int8_t*>(wt);
  a.k32 = k32;
  a.ep.thr = static_cast<const int32_t*>(thr);
  a.ep.wsum = static_cast<const int32_t*>(wsum);
  a.ep.nthr = nthr;
  a.ep.n_out = n_out;
  a.ep.level_off = level_off(abits);
  a.ep.codes_in = !input_levels;
  return launch_dense<kResNone>(a, out, static_cast<cudaStream_t>(stream));
}

// rows: int8 [m, k0] unsigned codes (levels) of the block's 3×3 conv, m =
// b·oh·ow; x2: int8 [b, h2, w2, c2] unsigned codes, the block input, with
// oh = (h2 − 1) / stride + 1 (and so ow); projection 0: the identity (c2 ==
// n_out, stride 1), r int32 [n_out], wt int8 [n_out, k32], k32 =
// round_up(k0, 32); projection 1: r unused, wt = [W_c ; W_p·diag(r)]
// transposed, int8 [n_out, k32], k32 = round_up(k0 + c2, 32), zero past
// k0 + c2; thr: int32 [nthr, n_out], nthr 1-3 (no weight sums: levels in);
// out: int8 [m, n_out] codes of MT(rows · W_c + r ⊙ p).
int bnn_dense_residual(const void* rows, int m, int k0, const void* x2,
                       int h2, int w2, int c2, int stride, int oh, int ow,
                       int projection, const void* r, const void* wt, int k32,
                       int n_out, const void* thr, int nthr, void* out,
                       void* stream) {
  using namespace bnn;
  const long long pixels = static_cast<long long>(m);
  if (m < 0 || k0 < 1 || n_out < 1 || c2 < 1 || stride < 1 || nthr < 1 ||
      nthr > 3 || oh != (h2 - 1) / stride + 1 || ow != (w2 - 1) / stride + 1 ||
      pixels % (static_cast<long long>(oh) * ow) != 0 ||
      k32 != round_up(projection ? k0 + c2 : k0, kMmaK) ||
      (!projection && (c2 != n_out || stride != 1 || r == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;

  DenseArgs a = {};
  a.x = static_cast<const int8_t*>(rows);
  a.m = m;
  a.k0 = k0;
  a.wt = static_cast<const int8_t*>(wt);
  a.k32 = k32;
  a.ep.thr = static_cast<const int32_t*>(thr);
  a.ep.nthr = nthr;
  a.ep.n_out = n_out;
  a.ep.codes_in = 0;
  const Shortcut sc = {
      static_cast<const int8_t*>(x2), h2, w2, c2, stride, oh, ow,
      static_cast<const int32_t*>(r),
      n_out % 2 == 0 && reinterpret_cast<uintptr_t>(x2) % 2 == 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ResidualArgs ra = {a, sc};
  return projection ? launch_dense<kResProjection>(ra, out, s)
                    : launch_dense<kResIdentity>(ra, out, s);
}

}  // extern "C"
