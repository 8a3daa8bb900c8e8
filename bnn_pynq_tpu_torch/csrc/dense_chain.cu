// A whole quantized MLP in one kernel: chained dense layers, codes in, float
// logits out.
//
// Replaces bnn_pynq_tpu/ops/fused_mlp.py::fused_mlp_forward (SFC/LFC, and
// CNV's tail with conv6 folded in). Entry point: bnn_fused_mlp.
// (bnn_pynq_tpu/ops/conv_stack.py::dense_block, which shares this body in
// the JAX package, has its own kernel here: dense_block.cu.) A second entry,
// bnn_dense_codes, runs the same kernel on one thresholded layer with the
// codes stored to device memory: conv_direct.cu hands it a conv whose kernel
// covers its input (few rows, a long K: 32-row blocks fill more of the card
// than dense_block.cu's 64-row ones, and the weights come by bulk copy).
//
// What bounds it on the H100: by the roofline, operations (2.0 G int8
// operations for CNV's tail at batch 1024, 0.001 ms at the card's 1,979
// TOP/s; 5.96 G and 0.003 ms for LFC), but in practice the weights' way into
// the SM. One launch must take a row through every layer, so a block owns
// its rows from the first layer to the last and has to see every weight
// (0.99 MB for CNV's tail, 2.9 MB for LFC, against 227 KB of shared memory):
// its time is at least that stream from L2 into one SM. What the design does
// about it:
// - the dots run on the int8 tensor cores (mma.sync m16n8k32, mma_tile.cuh),
//   so a block can own 32 rows (one warp item high) and not 8: at batch 1024
//   that is 32 streams of the weights from L2, where the dp4a kernel this
//   replaces made 128;
// - the weights come in tiles the host laid out for it (models/params.py,
//   WeightMatrix.tiles: 128-byte K slices, slice-major, so the rows of a
//   column pass are one contiguous run, their 16-byte chunks XOR-swizzled by
//   the row so ldmatrix reads them without bank conflicts at a pitch of 128).
//   A ninth warp is the producer: one thread asks for a whole tile with one
//   bulk copy (cp.async.bulk, completion on an mbarrier), so the eight
//   consumer warps issue no copy instruction at all (cp.async from every
//   thread cost more issue time here than the mma). The ring of three tiles
//   runs across column passes and layers without draining, since what to
//   fetch never depends on the activations;
// - a layer is cut into column passes of 8 warps × 32 columns (16 for a
//   layer of up to 128 columns): every warp has an item of each pass, the
//   A fragments come from the activation tile in shared memory (the tile's
//   input rows, one bulk copy a row, then each layer's output codes), the B
//   fragments from the ring. What belongs to a layer or a pass is computed
//   once there: the loop over K slices only adds constants to addresses;
// - codes, not levels, between layers: the epilogue thresholds the raw
//   accumulator against thresholds folded once per block (all layers', at
//   the start, behind the first copies) and writes int8 codes through the
//   warp's staging buffer into the other of two activation tiles, whose rows
//   are pitched ≡ 16 (mod 32) bytes so the next layer's ldmatrix reads them
//   in place;
// - the last layer turns its raw accumulator into the true one,
//   2·acc − off·wsum (acc itself on MobileNet's 4-bit codes, which are
//   their own levels), and applies scale and bias as a separate multiply and
//   add, as the JAX kernel does (an FMA would flip argmax ties); its few
//   columns (10) are masked, not padded.
// Rows past the batch's end repeat its last row and are masked at the store.
#include "mma_tile.cuh"

namespace bnn {
namespace {

constexpr int kMaxLayers = 8;
constexpr int kMlpRows = kItemRows;            // rows of a block
constexpr int kMlpSlice = 128;                 // bytes of K per ring stage
constexpr int kMlpStages = 3;
constexpr int kMlpThreads = kThreads + 32;     // 8 consumer warps, 1 producer

struct MlpLayer {
  const int8_t* tiles;   // [slices, n, 128] levels, chunks swizzled, zero
                         // past the layer's K
  const int32_t* thr;    // [nthr, n]; unused on a last layer that gives logits
  const int32_t* wsum;   // [n] column sums of the levels
  int k32;
  int n;
  int cw;                // columns a warp owns in a pass: 16 or 32
  int thr_off;           // where its folded thresholds start in thr_s (int32s)
  int thr_pad;           // columns of one row of them
};

struct MlpArgs {
  const int8_t* x;       // [m, k0] codes
  int m, k0;
  int vec_rows;          // rows of x are whole 16-byte vectors
  int n_layers;
  int nthr;
  int level_off;
  int codes_in;          // x holds 1- or 2-bit codes (level 2c − off); else
                         // 4-bit codes, their own levels
  int total_slices;      // ring tiles over all layers and passes
  int pitch[2];          // bytes per row of the two activation tiles
  int thr_total;         // int32s of folded thresholds, all layers
  int stage_bytes;       // one ring stage
  MlpLayer layer[kMaxLayers];
  float* out;            // [m, n_last] logits, or null:
  int8_t* out_codes;     // [m, n_last] codes of a thresholded last layer
  int out_vec;           // out_codes takes 16-byte stores
  const float* scale;
  const float* bias;
};

__host__ __device__ __forceinline__ int n_slices(const MlpLayer& L) {
  return (L.k32 + kMlpSlice - 1) / kMlpSlice;
}
__host__ __device__ __forceinline__ int n_passes(const MlpLayer& L) {
  return (L.n + kWarps * L.cw - 1) / (kWarps * L.cw);
}

// Up to four k32 steps of a warp's item on one ring tile. a0 / a1: the
// lane's ldmatrix addresses of the two m16 blocks at the tile's first step;
// brow[jp]: the address of the lane's weight row of pair jp in the tile;
// bx[jp]: that row's swizzle, (row & 7) ^ the lane's K half, so that step
// st's chunk 2·st + half lies at ((2·st) ^ bx) · 16.
template <int PAIRS>
__device__ __forceinline__ void tile_step(ItemAcc& acc, unsigned a0,
                                          unsigned a1,
                                          const unsigned (&brow)[2],
                                          const unsigned (&bx)[2], int st) {
  unsigned a[2][4], b[PAIRS][4];
  ldmatrix_x4(a[0], a0 + st * kMmaK);
  ldmatrix_x4(a[1], a1 + st * kMmaK);
#pragma unroll
  for (int jp = 0; jp < PAIRS; ++jp) {
    ldmatrix_x4(b[jp], brow[jp] + (((2 * st) ^ bx[jp]) << 4));
  }
#pragma unroll
  for (int jp = 0; jp < PAIRS; ++jp) {
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      mma_s8(acc.c[mb][2 * jp], a[mb], b[jp][0], b[jp][1]);
      mma_s8(acc.c[mb][2 * jp + 1], a[mb], b[jp][2], b[jp][3]);
    }
  }
}

// A whole tile runs without a branch, so that the loads of a step can go
// ahead of the mma of the one before; a layer's last tile may be shorter.
template <int PAIRS>
__device__ __forceinline__ void tile_mma(ItemAcc& acc, unsigned a0,
                                         unsigned a1,
                                         const unsigned (&brow)[2],
                                         const unsigned (&bx)[2], int steps) {
  constexpr int kSteps = kMlpSlice / kMmaK;
  if (steps == kSteps) {
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      tile_step<PAIRS>(acc, a0, a1, brow, bx, st);
    }
    return;
  }
  for (int st = 0; st < steps; ++st) {
    tile_step<PAIRS>(acc, a0, a1, brow, bx, st);
  }
}

// The last layer's epilogue: float(2·acc − off·wsum) · scale + bias for the
// item's real rows and columns (NJ n8 blocks wide), straight to device
// memory.
template <int NJ>
__device__ __forceinline__ void item_store_logits(
    const ItemAcc& acc, const MlpLayer& L, int mul, int level_off, float* out,
    const float* scale, const float* bias, size_t row0, int rows, int col0,
    int cols, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  // the lane's columns' constants first, all loads in flight together
  int sub[NJ][2];
  float sc[NJ][2], bi[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = col0 + min(8 * j + 2 * t + c, cols - 1);
      sub[j][c] = level_off * __ldg(L.wsum + col);
      sc[j][c] = __ldg(scale + col);
      bi[j][c] = __ldg(bias + col);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = 8 * j + 2 * t + c;
      if (n >= cols) continue;
      const int col = col0 + n;
      const float s = sc[j][c];
      const float b = bi[j][c];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = 16 * mb + 8 * h + g;
          if (rr < rows) {
            // two roundings, as JAX computes it; |mul·acc − sub| < 2^24,
            // so the conversion is exact
            out[(row0 + rr) * L.n + col] = __fadd_rn(
                __fmul_rn(__int2float_rn(mul * acc.c[mb][j][2 * h + c] -
                                         sub[j][c]),
                          s),
                b);
          }
        }
      }
    }
  }
}

// All nine warps meet here once per ring tile.
__device__ __forceinline__ void ring_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kMlpThreads) : "memory");
}

// The ninth warp: asks for the input rows, then for every weight tile, each
// as soon as the barrier shows its stage consumed. Lane 0 keeps the ring
// position of the next tile: K slice s of column pass `pass` of layer l.
__device__ __forceinline__ void producer_warp(const MlpArgs& a, int lane,
                                              int row0, int8_t* ring,
                                              int8_t* act0, unsigned full_bar,
                                              unsigned in_bar) {
  if (a.vec_rows) {   // one bulk copy a row
    if (lane == 0) mbar_expect_tx(in_bar, kMlpRows * a.k0);
    __syncwarp();
    const int row = min(row0 + lane, a.m - 1);
    bulk_copy(smem_addr(act0 + lane * a.pitch[0]),
              a.x + static_cast<size_t>(row) * a.k0, a.k0, in_bar);
  }
  int l = 0, pass = 0, s = 0;
  auto produce = [&](int slot) {
    const MlpLayer& L = a.layer[l];
    const int pass_cols = kWarps * L.cw;
    const int nc0 = pass * pass_cols;
    const unsigned bytes = min(pass_cols, L.n - nc0) * kMlpSlice;
    const unsigned bar = full_bar + 8 * slot;
    mbar_expect_tx(bar, bytes);
    bulk_copy(smem_addr(ring + slot * a.stage_bytes),
              L.tiles + (static_cast<size_t>(s) * L.n + nc0) * kMlpSlice,
              bytes, bar);
    if (++s == n_slices(L)) {
      s = 0;
      if (++pass == n_passes(L)) {
        pass = 0;
        ++l;
      }
    }
  };
  if (lane == 0) {
    for (int it = 0; it < kMlpStages - 1 && it < a.total_slices; ++it) {
      produce(it);
    }
  }
  for (int it = 0; it < a.total_slices; ++it) {
    ring_sync();   // tile it−1 is consumed: its stage is free
    if (lane == 0 && it + kMlpStages - 1 < a.total_slices) {
      produce((it + kMlpStages - 1) % kMlpStages);
    }
  }
}

// WIDE: the 15-threshold epilogue of 4-bit codes (mma_tile.cuh).
template <bool WIDE>
__global__ void __launch_bounds__(kMlpThreads, 1) mlp_kernel(const MlpArgs a) {
  extern __shared__ __align__(128) int8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the ring; two activation tiles (layer l reads tile l % 2 and writes the
  // other); the folded thresholds; a staging buffer per consumer warp; a
  // barrier per ring stage and one for the input rows
  int8_t* const ring = smem;
  int8_t* const act0 = ring + kMlpStages * a.stage_bytes;
  int8_t* const act1 = act0 + kMlpRows * a.pitch[0];
  int32_t* const thr_s =
      reinterpret_cast<int32_t*>(act1 + kMlpRows * a.pitch[1]);
  int8_t* const stages = reinterpret_cast<int8_t*>(thr_s + a.thr_total);
  const unsigned full_bar = smem_addr(stages + kWarps * kStageBytes);
  const unsigned in_bar = full_bar + 8 * kMlpStages;
  const int row0 = blockIdx.x * kMlpRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s <= kMlpStages; ++s) mbar_init(full_bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kWarps) {
    producer_warp(a, lane, row0, ring, act0, full_bar, in_bar);
    return;
  }

  // ---- the eight consumer warps ---------------------------------------------
  // every layer's thresholds, folded onto the raw accumulator, while the
  // first copies fly (read after the loop's first barrier)
  const int thr_layers = a.out_codes ? a.n_layers : a.n_layers - 1;
  for (int l = 0; l < thr_layers; ++l) {
    const MlpLayer& L = a.layer[l];
    const EpilogueArgs e = {L.thr, L.wsum, a.nthr, L.n, a.level_off,
                            a.codes_in};
    stage_thresholds<WIDE>(thr_s + L.thr_off, L.thr_pad, e, 0, L.n, kThreads);
  }
  if (a.vec_rows) {
    mbar_wait(in_bar, 0);
  } else {   // rows of another width: byte by byte
    for (int i = threadIdx.x; i < kMlpRows * a.k0; i += kThreads) {
      const int r = i / a.k0;
      const int k = i - r * a.k0;
      const int row = min(row0 + r, a.m - 1);
      act0[r * a.pitch[0] + k] =
          __ldg(a.x + static_cast<size_t>(row) * a.k0 + k);
    }
  }

  int8_t* const stage = stages + warp * kStageBytes;
  int slot = 0;
  unsigned parity = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const MlpLayer& L = a.layer[l];
    const int k32 = L.k32, n_out = L.n, cw = L.cw;
    const int slices = n_slices(L), passes = n_passes(L);
    const int pass_cols = kWarps * cw;
    const int pitch = a.pitch[l & 1];
    const unsigned a0 = smem_addr(l & 1 ? act1 : act0) +
                        a_lane_row(lane) * pitch + a_lane_k(lane);
    const unsigned a1 = a0 + 16 * pitch;
    const int n0 = warp * cw;              // within a pass
    for (int pass = 0; pass < passes; ++pass) {
      const int nc0 = pass * pass_cols;
      const int ncols = min(pass_cols, n_out - nc0);
      const bool active = n0 < ncols;      // warp-uniform
      // the lane's weight rows within a ring tile, and their swizzle
      unsigned brow[2], bx[2];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int r = max(min(n0 + 16 * jp + b_lane_col(lane), ncols - 1), 0);
        brow[jp] = r * kMlpSlice;
        bx[jp] = (r & 7) ^ (b_lane_k(lane) >> 4);
      }
      ItemAcc acc;
      item_clear(acc);
      for (int s = 0; s < slices; ++s) {
        ring_sync();   // the last tile is consumed, and the codes a finished
                       // pass wrote are visible
        mbar_wait(full_bar + 8 * slot, parity);
        if (active) {
          const unsigned tile = smem_addr(ring + slot * a.stage_bytes);
          const unsigned bb[2] = {tile + brow[0], tile + brow[1]};
          const int steps = min(kMlpSlice, k32 - s * kMlpSlice) / kMmaK;
          if (cw == 32) {
            tile_mma<2>(acc, a0 + s * kMlpSlice, a1 + s * kMlpSlice, bb, bx,
                        steps);
          } else {
            tile_mma<1>(acc, a0 + s * kMlpSlice, a1 + s * kMlpSlice, bb, bx,
                        steps);
          }
        }
        if (++slot == kMlpStages) {
          slot = 0;
          parity ^= 1;
        }
      }
      if (!active) continue;
      const int cols = min(cw, ncols - n0);
      const int col0 = nc0 + n0;
      const int rows = min(kMlpRows, a.m - row0);
      if (l + 1 < a.n_layers || a.out_codes) {
        // codes for every row of the tile into the other activation tile,
        // or a last layer's for the batch's rows into device memory
        const bool last = l + 1 == a.n_layers;
        int8_t* const dst = last ? a.out_codes : l & 1 ? act0 : act1;
        const int pitch_out = last ? n_out : a.pitch[(l + 1) & 1];
        const size_t dst_row0 = last ? row0 : 0;
        const int dst_rows = last ? rows : kMlpRows;
        const bool vec = cols % kVec == 0 && (!last || a.out_vec);
        const int32_t* thr = thr_s + L.thr_off + col0;
        if (cw == 32) {
          item_store_codes<4, WIDE>(acc, thr, L.thr_pad, a.nthr, stage, dst,
                              pitch_out, dst_row0, dst_rows, col0, cols, vec,
                              lane);
        } else {
          item_store_codes<2, WIDE>(acc, thr, L.thr_pad, a.nthr, stage, dst,
                              pitch_out, dst_row0, dst_rows, col0, cols, vec,
                              lane);
        }
      } else if (cw == 32) {
        item_store_logits<4>(acc, L, a.codes_in ? 2 : 1, a.level_off, a.out,
                             a.scale, a.bias, row0, rows, col0, cols, lane);
      } else {
        item_store_logits<2>(acc, L, a.codes_in ? 2 : 1, a.level_off, a.out,
                             a.scale, a.bias, row0, rows, col0, cols, lane);
      }
    }
  }
}

// Lay out and launch the kernel. w / wsum / thr: n_layers device pointers
// each; k32 / n: n_layers ints. out_logits (with scale and bias) or
// out_codes, the other null.
int launch_mlp(const void* x, int m, int k0, const void* const* wp,
               const void* const* sp, const void* const* tp, const int* k32s,
               const int* ns, int n_layers, int nthr, int abits,
               int input_levels,
               const void* scale, const void* bias, void* out_logits,
               void* out_codes, cudaStream_t stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || !nthr_ok(nthr) ||
      !abits_ok(abits) || m < 0 || k0 < 1 ||
      (out_logits == nullptr) == (out_codes == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;

  MlpArgs a = {};
  a.x = static_cast<const int8_t*>(x);
  a.m = m;
  a.k0 = k0;
  a.vec_rows = k0 % kVec == 0 && reinterpret_cast<uintptr_t>(x) % kVec == 0;
  a.n_layers = n_layers;
  a.nthr = nthr;
  a.codes_in = !input_levels;
  a.level_off = a.codes_in ? level_off(abits) : 0;
  int width[2] = {0, 0};          // the widest input of each activation tile
  int pass_cols = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int k_in = l == 0 ? k0 : ns[l - 1];
    if (k32s[l] != round_up(k_in, kMmaK) || ns[l] < 1 ||
        reinterpret_cast<uintptr_t>(wp[l]) % kVec != 0) {
      return cudaErrorInvalidValue;
    }
    MlpLayer& L = a.layer[l];
    L.tiles = static_cast<const int8_t*>(wp[l]);
    L.wsum = static_cast<const int32_t*>(sp[l]);
    L.thr = static_cast<const int32_t*>(tp[l]);
    L.k32 = k32s[l];
    L.n = ns[l];
    L.cw = L.n > kWarps * 16 ? 32 : 16;
    if (l + 1 < n_layers || out_codes != nullptr) {
      // an item's epilogue reads 64 columns of thresholds from its first
      L.thr_off = a.thr_total;
      L.thr_pad = round_up(L.n, kItemCols) + kItemCols;
      a.thr_total += nthr == kMaxThr ? thr_words<true>(nthr, L.thr_pad)
                                     : thr_words<false>(nthr, L.thr_pad);
    }
    a.total_slices += n_passes(L) * n_slices(L);
    width[l & 1] = width[l & 1] > L.k32 ? width[l & 1] : L.k32;
    pass_cols = pass_cols > kWarps * L.cw ? pass_cols : kWarps * L.cw;
  }
  a.pitch[0] = padded_pitch(width[0]);
  a.pitch[1] = padded_pitch(width[1]);
  a.stage_bytes = pass_cols * kMlpSlice;
  a.out = static_cast<float*>(out_logits);
  a.out_codes = static_cast<int8_t*>(out_codes);
  a.out_vec = ns[n_layers - 1] % kVec == 0 &&
              reinterpret_cast<uintptr_t>(out_codes) % kVec == 0;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);

  const size_t smem =
      static_cast<size_t>(kMlpStages) * a.stage_bytes +
      static_cast<size_t>(kMlpRows) * (a.pitch[0] + a.pitch[1]) +
      static_cast<size_t>(a.thr_total) * 4 +
      static_cast<size_t>(kWarps) * kStageBytes + 8 * (kMlpStages + 1);
  const auto kernel = nthr == kMaxThr ? mlp_kernel<true> : mlp_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);   // too wide: invalid value
  if (err != cudaSuccess) return err;
  const int blocks = (m + kMlpRows - 1) / kMlpRows;
  kernel<<<blocks, kMlpThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bnn

extern "C" {

// fused_mlp: x codes [m, k0] → float32 logits [m, n_last]; every layer but
// the last is thresholded, the last applies scale/bias.
// tile_ptrs / wsum_ptrs / thr_ptrs: host arrays of n_layers device pointers
// (the weights' 128-byte K tiles, int8 [ceil(k32 / 128), n, 128], swizzled
// as WeightMatrix.tiles; their int32 column sums [n]; int32 thresholds
// [nthr, n], the last layer's unused); k32 / n: host int arrays of n_layers
// entries, k32 the layer's K rounded up to 32; input_levels: the codes are
// their own levels (unsigned), every layer's.
int bnn_fused_mlp(const void* x, int m, int k0, const void* tile_ptrs,
                  const void* wsum_ptrs, const void* thr_ptrs,
                  const void* k32, const void* n, int n_layers, int nthr,
                  int abits, int input_levels, const void* scale,
                  const void* bias, void* out, void* stream) {
  return bnn::launch_mlp(
      x, m, k0, static_cast<const void* const*>(tile_ptrs),
      static_cast<const void* const*>(wsum_ptrs),
      static_cast<const void* const*>(thr_ptrs), static_cast<const int*>(k32),
      static_cast<const int*>(n), n_layers, nthr, abits, input_levels, scale,
      bias, out, nullptr, static_cast<cudaStream_t>(stream));
}

// One thresholded dense layer: x codes [m, k0] → int8 codes [m, n_out].
// tiles, wsum, thr, input_levels as one layer of bnn_fused_mlp.
int bnn_dense_codes(const void* x, int m, int k0, const void* tiles, int k32,
                    int n_out, const void* wsum, const void* thr, int nthr,
                    int abits, int input_levels, void* out, void* stream) {
  return bnn::launch_mlp(x, m, k0, &tiles, &wsum, &thr, &k32, &n_out, 1, nthr,
                         abits, input_levels, nullptr, nullptr, nullptr, out,
                         static_cast<cudaStream_t>(stream));
}

const char* bnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
