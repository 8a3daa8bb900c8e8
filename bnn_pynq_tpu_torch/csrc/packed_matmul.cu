// Quantized matmul on bit-packed operands, with a fused MultiThreshold, on
// the tensor cores.
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
// What bounds it on the H100: a `vpu` forward of CNV-W1A1 at batch 1024 is
// 59 G binary MACs in 8 layers and 172 MB of words in and codes out. The
// decode arm multiplies int8 levels: 0.063 ms at the card's 1,979 int8 TOP/s.
// The popcount arm's operands are single bits, which the tensor cores take 8
// to an int8 operand at the same instruction rate (0.0075 ms), so its bound
// is its bytes: 0.051 ms at 3.35 TB/s. The CUDA cores cannot get near
// either: popc runs at 16 a clock an SM and dp4a at 64, which put the
// two arms at 0.5 and 1.0 ms before anything else is counted. So both dots
// run on the tensor cores, on mma_tile.cuh's 32-row × 64-column warp item:
//
// - Popcount arm: mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc.
//   Counted in bytes its fragments are those of the int8 m16n8k32 (A: four
//   4-byte registers at rows g, g+8 and byte offsets 4t, 16+4t of a 32-byte
//   K step; B: two a column), and a popcount does not care how the 256 bits
//   of a step are ordered as long as both operands share the order, so the
//   packed words are the operands as they lie in memory: no decode, no
//   reorder. The AND form is the one this card's tensor cores run (the XOR
//   form assembles for sm_90a but reaches a tenth of its rate), so
//       popc(a XOR w) = popc(a) + popc(w) − 2·popc(a AND w)
//       acc = k − 2·popc(a XOR w) = 2·(2·AND − popc(a)) − (2·popc(w) − k).
//   popc(a) per row comes out of the tensor cores too: one more n8 block
//   per m16 block whose B operand is all ones over the row's real words (two
//   mma beside sixteen). popc(w) per column is counted once per block from
//   the staged weights. The epilogue turns the accumulators into
//   raw = 2·AND − popc(a) and the column's constant is folded into the
//   staged thresholds, raw ≥ ceil((thr + 2·popc(w) − k) / 2), in 64 bits.
//   Only the weights' K padding (up to a whole 32-byte step) has to be zero:
//   whatever lies behind a row's last word meets zero weight bits and a zero
//   ones-mask.
// - Decode arm: m16n8k32.s8 on levels. The weights are decoded once per
//   block, into shared memory rows pitched ≡ 16 (mod 32) bytes, and read by
//   ldmatrix. The activations are decoded in registers, straight into the A
//   fragments: a lane's register a0 of a 32-level K step is 4 bits (or 4
//   codes) of one packed word, a shift, a mask and a few integer operations
//   away. (Decoding a tile's words into a levels tile in shared memory first
//   was built and measured: at K = 1152 the 32 × K bytes an item's rows take
//   leave room for two items a block, 190 TOP/s at CNV's conv3; the words
//   themselves are an eighth or a quarter of that, so a tile keeps an item
//   for every warp.) The pad positions inside the last word decode to
//   −1 / −3 in both operands and pad_term is added to the thresholds; K
//   behind the last word is zero levels in the weights.
// - The weights are staged once per persistent block, transposed to the
//   [column][K] rows the B fragments are read from (words, or decoded
//   levels), in column chunks where they do not fit beside the activations
//   (on the grid's second axis while the tiles alone leave room on the card).
// - A block walks tiles of consecutive rows. A tile's words are one linear
//   run of device memory whatever kw is, so they are copied as they lie, by
//   16-byte cp.async, the next tile behind the current one's mma (two
//   buffers), and both arms read their A operand from that run with plain
//   32-bit shared loads (a row of kw words has no alignment ldmatrix could
//   use: 72 bytes at CNV's conv1).
// - Where the rows are few (a batch-1 dense layer, CNV's last convs) the
//   launcher cuts the columns a block stages down to 64 and the tile down
//   to 32 rows until the grid has a block for every SM: staging the weights
//   is what such a call costs.
// - Thresholds and stores are mma_tile.cuh's: staged folded thresholds,
//   16-byte stores of codes through a per-warp staging buffer, the int32
//   output as 8-byte stores.
// - K too long for that (8 weight columns beside two buffers of a 32-row
//   tile's words no longer fit in shared memory: beyond about 13,000 1-bit or
//   9,000 2-bit levels on the decode arm, 24,000 bits on the popcount arm)
//   goes to sliced_kernel: the same item for every warp, both operands staged
//   a slice of K at a time, the accumulators (and popc(a), popc(w)) kept
//   across the slices, the thresholds folded after the last.
// Any m, n and K.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, CNV-W1A1's eight
// packed layers at batch 1024, CUDA graph replay): 0.137 ms on the popcount
// arm and 0.312 ms on the decode arm, against 0.62 and 1.43 ms for the
// CUDA-core kernel this replaces (a thread per 4 × 4 outputs on popc and
// dp4a instructions) in the same run; mma.sync alone reaches 10,100 binary TOP/s with
// .and.popc and 1,260 int8 TOP/s (tools/layer_times.py). What is left on the
// popcount arm is the epilogue and the stores of the codes. PERF.md §6.
#include <algorithm>

#include "mma_tile.cuh"

namespace bnn {
namespace {

enum Arm : int { kPopc = 0, kDecode1 = 1, kDecode2 = 2 };
enum Out : int { kCodes = 0, kAcc = 1 };

struct PackedArgs {
  const uint32_t* a;     // [m, kw]
  const uint32_t* w;     // [kw, n]
  const int32_t* thr;    // [nthr, n], or null
  void* out;             // [m, n] int8 codes or int32
  int m, kw, n, k, nthr;
  int pad_term;          // decode arm: what the pad positions add to the dot
  int tile;              // rows per tile, a multiple of kItemRows
  int n_chunk;           // weight columns staged at once
  int kb32;              // staged bytes of K per weight row: words, or
                         // levels; a multiple of kMmaK
  int w_pitch;           // bytes per staged weight row
  int raw_bytes;         // bytes of one buffer of a tile's words
  int slice;             // sliced_kernel: words of K staged at once, a
                         // multiple of 8
  int a_vec;             // the run of words is copied 16 bytes at a time
  int out_vec;           // codes: out is 16-byte aligned and n % 16 == 0;
                         // accumulators: 8-byte aligned and n % 2 == 0
};

// Bytes a packed word takes in shared memory: itself, or its levels.
template <int ARM>
constexpr int kWordBytes = ARM == kPopc ? 4 : (ARM == kDecode1 ? 32 : 16);

// Four 1-bit fields (bits 0..3 of x) → four int8 levels 2b-1, byte i = bit i.
// The product puts bit i at bit 8i (the 16 partial products i + 7j land on
// 16 different bits, so nothing carries); a byte 1 then becomes 0xfe ^ 0xff
// = +1, a byte 0 becomes 0xff = −1.
__device__ __forceinline__ uint32_t levels1(uint32_t x) {
  const uint32_t s = ((x & 0xfu) * 0x00204081u) & 0x01010101u;
  return (s * 0xfeu) ^ 0xffffffffu;
}

// Four 2-bit codes (bits 0..7 of x) → four int8 levels 2c-3, byte i = code i.
__device__ __forceinline__ uint32_t levels2(uint32_t x) {
  const uint32_t s = (x & 0x3u) | ((x & 0xCu) << 6) | ((x & 0x30u) << 12) |
                     ((x & 0xC0u) << 18);
  return __vsub4(s << 1, 0x03030303u);
}

// A packed word as it is staged: the word, or its levels in natural order
// (byte i of the staged run = element i of the word), the same in both
// operands. dst is 16-byte aligned on the decode arm. (Weights only: the
// activations' levels are made in registers, item_decode.)
template <int ARM>
__device__ __forceinline__ void stage_word(uint32_t word, int8_t* dst) {
  if constexpr (ARM == kPopc) {
    *reinterpret_cast<uint32_t*>(dst) = word;
  } else if constexpr (ARM == kDecode1) {
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

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// c += popc(a AND b) over a 16 × 8 tile and 256 bits of K.
__device__ __forceinline__ void mma_b1(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Weight columns [nc0, nc0 + ncols) into shared memory, transposed: row n
// holds column nc0 + n along K (words, or levels), zero from the last word
// up to kb32.
template <int ARM>
__device__ __forceinline__ void stage_weights(const PackedArgs& p,
                                              int8_t* wsm, int nc0,
                                              int ncols) {
  constexpr int kWb = kWordBytes<ARM>;
  for (int idx = threadIdx.x; idx < p.kw * ncols; idx += blockDim.x) {
    const int c = idx / ncols;
    const int col = idx - c * ncols;
    const uint32_t word =
        __ldg(p.w + static_cast<size_t>(c) * p.n + nc0 + col);
    stage_word<ARM>(word, wsm + col * p.w_pitch + c * kWb);
  }
  const int tail = (p.kb32 - p.kw * kWb) / 4;
  for (int idx = threadIdx.x; idx < ncols * tail; idx += blockDim.x) {
    const int col = idx / tail;
    const int j = idx - col * tail;
    reinterpret_cast<uint32_t*>(wsm + col * p.w_pitch + p.kw * kWb)[j] = 0u;
  }
}

// The set bits of a staged weight row of `bytes` bytes (a multiple of 32).
__device__ __forceinline__ int row_ones(const int8_t* row, int bytes) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
  int ones = 0;
  for (int j = 0; j < bytes / kVec; ++j) {
    const uint4 v = r[j];
    ones += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  }
  return ones;
}

// What the epilogue needs of columns [nc0, nc0 + ncols), from the staged
// weights (the caller synchronized after stage_weights, and synchronizes
// after this). The true accumulator is mul·raw − add[n]:
//   popcount arm  raw = 2·AND − popc(a row), mul = 2, add = 2·popc(w col) − k
//   decode arm    raw = the dot,             mul = 1, add = pad_term
// kCodes: thr_s[t · cols_pad + n] = ceil((thr + add) / mul), in 64 bits and
// clamped (|raw| < 2^24, so a clamped threshold compares as the true one);
// columns past ncols never pass. kAcc: thr_s[n] = add (0 past ncols).
// ones_s: popc(w col) where the caller has counted it (sliced_kernel), else
// null and it is counted here from the staged weights, which hold all of K.
template <int ARM, int OUT>
__device__ __forceinline__ void stage_epilogue(const PackedArgs& p,
                                               const int8_t* wsm,
                                               int32_t* thr_s, int cols_pad,
                                               int nc0, int ncols,
                                               const int32_t* ones_s = nullptr) {
  for (int n = threadIdx.x; n < cols_pad; n += blockDim.x) {
    long long add = 0;
    if (n < ncols) {
      if constexpr (ARM == kPopc) {
        const int ones = ones_s != nullptr
                             ? ones_s[n]
                             : row_ones(wsm + n * p.w_pitch, p.kb32);
        add = 2 * ones - p.k;
      } else {
        add = p.pad_term;
      }
    }
    if constexpr (OUT == kAcc) {
      thr_s[n] = static_cast<int32_t>(add);
    } else {
      for (int t = 0; t < p.nthr; ++t) {
        long long x = kThrNever;
        if (n < ncols) {
          x = __ldg(p.thr + t * p.n + nc0 + n) + add;
          if constexpr (ARM == kPopc) x = (x + 1) >> 1;
          x = x > kThrNever ? kThrNever
                            : (x < -kThrNever - 1 ? -kThrNever - 1 : x);
        }
        thr_s[t * cols_pad + n] = static_cast<int32_t>(x);
      }
    }
  }
}

// Start the copy of a tile's words, as they lie in device memory, into
// `raw`. The run starts on a 16-byte boundary when `a` does (a tile is a
// multiple of 32 rows); its last bytes, where the rows end before a
// boundary, go 4 at a time.
__device__ __forceinline__ void copy_words_async(const PackedArgs& p, int tile,
                                                 uint32_t* raw) {
  const int row0 = tile * p.tile;
  const int words = min(p.tile, p.m - row0) * p.kw;
  const uint32_t* src = p.a + static_cast<size_t>(row0) * p.kw;
  const unsigned dst = smem_addr(raw);
  const int vec_words = p.a_vec ? words / 4 * 4 : 0;
  for (int i = threadIdx.x * 4; i < vec_words; i += blockDim.x * 4) {
    cp_async16(dst + i * 4, src + i);
  }
  for (int i = vec_words + threadIdx.x; i < words; i += blockDim.x) {
    cp_async4(dst + i * 4, src + i);
  }
}

// `steps` K steps of 256 bits of a warp item on the popcount arm.
//   rows: the lane's first A word: tile row m0 + g, word t; row r of the
//     item lies r·kw words further. Words behind a row's last (the next
//     row's, or whatever follows the tile) meet zero weight bits.
//   ra[mb]: popc of the lane's rows, c0 = c1 for row g, c2 = c3 for g + 8.
__device__ __forceinline__ void item_popc(ItemAcc& acc, int (&ra)[2][4],
                                          const uint32_t* rows, int kw,
                                          const unsigned (&b_addr)[4],
                                          int steps, int ncols, int t) {
  for (int s = 0; s < steps; ++s) {
    const int w0 = 8 * s;
    unsigned a[2][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const uint32_t* r = rows + 16 * mb * kw + w0;
      a[mb][0] = r[0];
      a[mb][1] = r[8 * kw];
      a[mb][2] = r[4];
      a[mb][3] = r[8 * kw + 4];
    }
    const unsigned ones0 = w0 + t < kw ? 0xffffffffu : 0u;
    const unsigned ones1 = w0 + 4 + t < kw ? 0xffffffffu : 0u;
    mma_b1(ra[0], a[0], ones0, ones1);
    mma_b1(ra[1], a[1], ones0, ones1);
    const unsigned off = static_cast<unsigned>(s) * kMmaK;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp * 16 < ncols) {
        unsigned b[4];
        ldmatrix_x4(b, b_addr[jp] + off);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          mma_b1(acc.c[mb][2 * jp], a[mb], b[0], b[1]);
          mma_b1(acc.c[mb][2 * jp + 1], a[mb], b[2], b[3]);
        }
      }
    }
  }
}

// `steps` K steps of 32 levels of a warp item on the decode arm: the A
// fragments are decoded from the packed words in registers.
//   rows: the first word of the lane's row, tile row m0 + g; row r of the
//     item lies r·kw words further.
//   1 bit: step s is word s; a0 = its bits 4t..4t+3, a2 = bits 16+4t...
//   2 bits: step s is words 2s, 2s+1; a0 = codes 4t..4t+3 of the first, a2
//     of the second (behind an odd kw's last word: someone else's word,
//     which meets zero weight levels).
template <int ARM>
__device__ __forceinline__ void item_decode(ItemAcc& acc, const uint32_t* rows,
                                            int kw,
                                            const unsigned (&b_addr)[4],
                                            int steps, int ncols, int t) {
  for (int s = 0; s < steps; ++s) {
    unsigned a[2][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const uint32_t* r = rows + 16 * mb * kw;
      if constexpr (ARM == kDecode1) {
        const uint32_t lo = r[s] >> (4 * t);
        const uint32_t hi = r[8 * kw + s] >> (4 * t);
        a[mb][0] = levels1(lo);
        a[mb][1] = levels1(hi);
        a[mb][2] = levels1(lo >> 16);
        a[mb][3] = levels1(hi >> 16);
      } else {
        a[mb][0] = levels2(r[2 * s] >> (8 * t));
        a[mb][1] = levels2(r[8 * kw + 2 * s] >> (8 * t));
        a[mb][2] = levels2(r[2 * s + 1] >> (8 * t));
        a[mb][3] = levels2(r[8 * kw + 2 * s + 1] >> (8 * t));
      }
    }
    const unsigned off = static_cast<unsigned>(s) * kMmaK;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp * 16 < ncols) {
        unsigned b[4];
        ldmatrix_x4(b, b_addr[jp] + off);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          mma_s8(acc.c[mb][2 * jp], a[mb], b[0], b[1]);
          mma_s8(acc.c[mb][2 * jp + 1], a[mb], b[2], b[3]);
        }
      }
    }
  }
}

// The item's epilogue: the popcount arm's raw = 2·AND − popc(a row), then
// the codes or the true accumulators of item rows [0, item_rows) at output
// row out_row, columns [col0, col0 + cols). thr_s: stage_epilogue's, at the
// item's first column.
template <int ARM, int OUT>
__device__ __forceinline__ void item_finish(const PackedArgs& p, ItemAcc& acc,
                                            const int (&ra)[2][4],
                                            const int32_t* thr_s, int cols_pad,
                                            int8_t* stage, size_t out_row,
                                            int item_rows, int col0, int cols,
                                            int lane) {
  if constexpr (ARM == kPopc) {
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc.c[mb][j][e] = 2 * acc.c[mb][j][e] - ra[mb][e & 2];
        }
  }
  if constexpr (OUT == kAcc) {
    item_store_acc(acc, thr_s, ARM == kPopc ? 2 : 1,
                   static_cast<int32_t*>(p.out), p.n, out_row, item_rows, col0,
                   cols, p.out_vec, lane);
  } else {
    item_store_codes(acc, thr_s, cols_pad, p.nthr, stage,
                     static_cast<int8_t*>(p.out), p.n, out_row, item_rows,
                     col0, cols,
                     p.out_vec && col0 % kVec == 0 && cols % kVec == 0, lane);
  }
}

template <int ARM, int OUT>
__global__ void __launch_bounds__(kThreads, 2)
packed_kernel(const PackedArgs p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cols_pad = round_up(p.n_chunk, kItemCols);
  const int thr_rows = OUT == kAcc ? 1 : p.nthr;

  int8_t* const wsm = smem;
  int32_t* const thr_s = reinterpret_cast<int32_t*>(
      smem + static_cast<size_t>(p.n_chunk) * p.w_pitch);
  int8_t* const stages = reinterpret_cast<int8_t*>(thr_s + thr_rows * cols_pad);
  int8_t* const stage = stages + warp * kStageBytes;
  // two buffers of a tile's words
  uint32_t* const raw0 =
      reinterpret_cast<uint32_t*>(stages + kWarps * kStageBytes);
  uint32_t* const raw1 = reinterpret_cast<uint32_t*>(
      reinterpret_cast<int8_t*>(raw0) + p.raw_bytes);

  const int ntiles = (p.m + p.tile - 1) / p.tile;
  const int tile_step = gridDim.x;
  const int steps = p.kb32 / kMmaK;

  for (int nc0 = blockIdx.y * p.n_chunk; nc0 < p.n;
       nc0 += gridDim.y * p.n_chunk) {
    const int ncols = min(p.n_chunk, p.n - nc0);
    __syncthreads();   // the last pass's reads of shared memory are done
    stage_weights<ARM>(p, wsm, nc0, ncols);
    int tile = blockIdx.x;
    int cur = 0;
    if (tile < ntiles) copy_words_async(p, tile, raw0);
    cp_async_commit();
    __syncthreads();   // the weights are there
    stage_epilogue<ARM, OUT>(p, wsm, thr_s, cols_pad, nc0, ncols);

    for (; tile < ntiles; tile += tile_step) {
      const int row0 = tile * p.tile;
      const int rows = min(p.tile, p.m - row0);
      const int next = tile + tile_step;
      const uint32_t* raw_cur = cur ? raw1 : raw0;
      if (next < ntiles) copy_words_async(p, next, cur ? raw0 : raw1);
      cp_async_commit();
      cp_async_wait<1>();   // all but the copy just started have landed
      __syncthreads();
      cur ^= 1;

      const int m_items = (rows + kItemRows - 1) / kItemRows;
      const int n_items = (ncols + kItemCols - 1) / kItemCols;
      for (int item = warp; item < m_items * n_items; item += kWarps) {
        const int mi = item % m_items;
        const int ni = item / m_items;
        const int m0 = mi * kItemRows;
        const int n0 = ni * kItemCols;        // within the staged chunk
        const int cols = min(kItemCols, ncols - n0);

        unsigned b_addr[4];
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const int n = min(n0 + 16 * jp + b_lane_col(lane), ncols - 1);
          b_addr[jp] = smem_addr(wsm) + n * p.w_pitch + b_lane_k(lane);
        }
        ItemAcc acc;
        item_clear(acc);
        int ra[2][4] = {};
        if constexpr (ARM == kPopc) {
          item_popc(acc, ra, raw_cur + (m0 + (lane >> 2)) * p.kw + (lane & 3),
                    p.kw, b_addr, steps, cols, lane & 3);
        } else {
          item_decode<ARM>(acc, raw_cur + (m0 + (lane >> 2)) * p.kw, p.kw,
                           b_addr, steps, cols, lane & 3);
        }
        item_finish<ARM, OUT>(p, acc, ra, thr_s + n0, cols_pad, stage,
                              static_cast<size_t>(row0 + m0),
                              min(kItemRows, rows - m0), nc0 + n0, cols, lane);
      }
      __syncthreads();   // the buffers are free for the next tile
    }
    cp_async_wait<0>();
  }
}

// The same for a K too long for a block to hold whole rows of it. A unit of
// work is a tile of rows × a chunk of columns with an item for every warp;
// its K is walked in slices of p.slice words: the weights' slice staged and
// transposed as above, the rows' slice copied at a pitch of the slice's own
// words (so that the item loops read it as they read a whole row), the
// accumulators kept in registers from slice to slice. popc(w col) is summed
// over the slices in shared memory; the thresholds are folded after the last.
template <int ARM, int OUT>
__global__ void __launch_bounds__(kThreads, 1)
sliced_kernel(const PackedArgs p) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int kWb = kWordBytes<ARM>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cols_pad = round_up(p.n_chunk, kItemCols);
  const int thr_rows = OUT == kAcc ? 1 : p.nthr;

  int8_t* const wsm = smem;
  int32_t* const thr_s = reinterpret_cast<int32_t*>(
      smem + static_cast<size_t>(p.n_chunk) * p.w_pitch);
  int32_t* const ones_s = thr_s + thr_rows * cols_pad;
  int8_t* const stages = reinterpret_cast<int8_t*>(ones_s + cols_pad);
  int8_t* const stage = stages + warp * kStageBytes;
  uint32_t* const raw =
      reinterpret_cast<uint32_t*>(stages + kWarps * kStageBytes);

  const int ntiles = (p.m + p.tile - 1) / p.tile;
  const int chunks = (p.n + p.n_chunk - 1) / p.n_chunk;
  for (long long unit = blockIdx.x;
       unit < static_cast<long long>(ntiles) * chunks; unit += gridDim.x) {
    const int row0 = static_cast<int>(unit / chunks) * p.tile;
    const int nc0 = static_cast<int>(unit % chunks) * p.n_chunk;
    const int rows = min(p.tile, p.m - row0);
    const int ncols = min(p.n_chunk, p.n - nc0);
    const int m_items = (rows + kItemRows - 1) / kItemRows;
    const int n_items = (ncols + kItemCols - 1) / kItemCols;
    const bool active = warp < m_items * n_items;    // at most an item a warp
    const int m0 = warp % m_items * kItemRows;
    const int n0 = warp / m_items * kItemCols;       // within the chunk
    const int cols = min(kItemCols, ncols - n0);
    unsigned b_addr[4];
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int n = min(n0 + 16 * jp + b_lane_col(lane), ncols - 1);
      b_addr[jp] = smem_addr(wsm) + n * p.w_pitch + b_lane_k(lane);
    }
    ItemAcc acc;
    item_clear(acc);
    int ra[2][4] = {};
    for (int n = threadIdx.x; n < cols_pad; n += blockDim.x) ones_s[n] = 0;

    for (int c0 = 0; c0 < p.kw; c0 += p.slice) {
      PackedArgs q = p;              // the slice as an operand pair of its own
      q.kw = min(p.slice, p.kw - c0);
      q.kb32 = round_up(q.kw * kWb, kMmaK);
      q.w = p.w + static_cast<size_t>(c0) * p.n;
      __syncthreads();   // the last slice's (or unit's) reads are done
      stage_weights<ARM>(q, wsm, nc0, ncols);
      for (int idx = threadIdx.x; idx < rows * q.kw; idx += blockDim.x) {
        const int r = idx / q.kw;
        raw[idx] = __ldg(p.a + static_cast<size_t>(row0 + r) * p.kw + c0 +
                         (idx - r * q.kw));
      }
      __syncthreads();
      if constexpr (ARM == kPopc) {
        for (int n = threadIdx.x; n < ncols; n += blockDim.x) {
          ones_s[n] += row_ones(wsm + n * p.w_pitch, q.kb32);
        }
      }
      if (active) {
        const int steps = q.kb32 / kMmaK;
        if constexpr (ARM == kPopc) {
          item_popc(acc, ra, raw + (m0 + (lane >> 2)) * q.kw + (lane & 3),
                    q.kw, b_addr, steps, cols, lane & 3);
        } else {
          item_decode<ARM>(acc, raw + (m0 + (lane >> 2)) * q.kw, q.kw, b_addr,
                           steps, cols, lane & 3);
        }
      }
    }
    __syncthreads();   // every column's popc(w) is whole
    stage_epilogue<ARM, OUT>(p, wsm, thr_s, cols_pad, nc0, ncols, ones_s);
    __syncthreads();
    if (active) {
      item_finish<ARM, OUT>(p, acc, ra, thr_s + n0, cols_pad, stage,
                            static_cast<size_t>(row0 + m0),
                            min(kItemRows, rows - m0), nc0 + n0, cols, lane);
    }
  }
}

// Size and launch sliced_kernel: up to 256 columns a chunk, a tile with an
// item for each warp, and the longest slice of K (whole 256-bit steps) that
// fits beside them.
template <int ARM, int OUT>
int launch_sliced(PackedArgs& p, int sms, cudaStream_t stream) {
  constexpr int kWb = kWordBytes<ARM>;
  const int thr_rows = OUT == kAcc ? 1 : p.nthr;
  p.n_chunk = std::min(round_up(p.n, 8), 4 * kItemCols);
  const int n_items = (p.n_chunk + kItemCols - 1) / kItemCols;
  p.tile = kItemRows * std::max(1, kWarps / n_items);
  const size_t fixed = static_cast<size_t>(p.n_chunk) * kPitchPad +
                       epilogue_smem(thr_rows, p.n_chunk) +
                       static_cast<size_t>(round_up(p.n_chunk, kItemCols)) * 4 +
                       kMmaK;
  const size_t per_word = static_cast<size_t>(p.n_chunk) * kWb + p.tile * 4;
  p.slice = static_cast<int>((kMaxSmem - fixed) / per_word) / 8 * 8;
  if (p.slice < 8) return cudaErrorInvalidValue;
  p.w_pitch = p.slice * kWb + kPitchPad;
  p.raw_bytes = p.tile * p.slice * 4 + kMmaK;
  const size_t smem = fixed + per_word * p.slice;
  cudaError_t err = allow_smem(sliced_kernel<ARM, OUT>, smem);
  if (err != cudaSuccess) return err;
  const long long units = static_cast<long long>((p.m + p.tile - 1) / p.tile) *
                          ((p.n + p.n_chunk - 1) / p.n_chunk);
  sliced_kernel<ARM, OUT>
      <<<static_cast<unsigned>(std::min<long long>(units, sms)), kThreads,
         smem, stream>>>(p);
  return cudaGetLastError();
}

template <int ARM, int OUT>
int launch_packed(PackedArgs& p, cudaStream_t stream) {
  constexpr int kWb = kWordBytes<ARM>;
  const int thr_rows = OUT == kAcc ? 1 : p.nthr;
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return err;
  }
  if (static_cast<long long>(p.kw) * kWb > kMaxSmem) {
    return launch_sliced<ARM, OUT>(p, sms, stream);
  }
  p.kb32 = round_up(p.kw * kWb, kMmaK);
  p.w_pitch = p.kb32 + kPitchPad;

  // A tile has an item for each warp: 8 / (64-column items of a chunk) row
  // items. Halve the staged columns while they alone take more than two
  // thirds of shared memory, then shrink the tile, then the columns again,
  // until it fits; a K that leaves no room even then is walked in slices.
  p.n_chunk = std::min(round_up(p.n, 8), 4 * kItemCols);
  while (p.n_chunk > 8 && static_cast<size_t>(p.n_chunk) * p.w_pitch >
                              static_cast<size_t>(kMaxSmem) / 3 * 2) {
    p.n_chunk = round_up(p.n_chunk / 2, 8);
  }
  const int n_items = (p.n_chunk + kItemCols - 1) / kItemCols;
  p.tile = kItemRows * std::max(1, kWarps / n_items);
  const auto smem_of = [&](int tile) {
    p.raw_bytes = round_up(tile * p.kw * 4 + kMmaK, kVec);
    return static_cast<size_t>(p.n_chunk) * p.w_pitch +
           epilogue_smem(thr_rows, p.n_chunk) +
           2 * static_cast<size_t>(p.raw_bytes);
  };
  while (smem_of(p.tile) > static_cast<size_t>(kMaxSmem)) {
    if (p.tile > kItemRows) {
      p.tile /= 2;
    } else if (p.n_chunk > 8) {
      p.n_chunk = round_up(p.n_chunk / 2, 8);
    } else {
      return launch_sliced<ARM, OUT>(p, sms, stream);
    }
  }
  // Few rows: more, smaller blocks until every SM has one, the columns
  // first (staging them is the larger part of such a block's time).
  const auto blocks_of = [&]() {
    return static_cast<long long>((p.m + p.tile - 1) / p.tile) *
           ((p.n + p.n_chunk - 1) / p.n_chunk);
  };
  while (blocks_of() < sms) {
    if (p.n_chunk > kItemCols) {
      p.n_chunk = std::max(kItemCols, round_up(p.n_chunk / 2, 8));
    } else if (p.tile > kItemRows) {
      p.tile /= 2;
    } else {
      break;
    }
  }
  const size_t smem = smem_of(p.tile);   // also sets raw_bytes

  if ((err = allow_smem(packed_kernel<ARM, OUT>, smem)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &resident, packed_kernel<ARM, OUT>, kThreads, smem)) !=
      cudaSuccess) {
    return err;
  }
  if (resident < 1) return cudaErrorInvalidValue;
  const long long ntiles = (p.m + p.tile - 1) / p.tile;
  const long long room = static_cast<long long>(sms) * resident;
  // the column chunks on the grid's second axis while the tiles alone leave
  // room on the card: each block then stages one chunk, once
  const int chunks = (p.n + p.n_chunk - 1) / p.n_chunk;
  const int grid_y = ntiles < room ? chunks : 1;
  const dim3 grid(static_cast<unsigned>(ntiles < room ? ntiles : room), grid_y);
  packed_kernel<ARM, OUT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int ARM>
int launch_arm(PackedArgs& p, cudaStream_t stream) {
  return p.thr != nullptr ? launch_packed<ARM, kCodes>(p, stream)
                          : launch_packed<ARM, kAcc>(p, stream);
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
      (thr == nullptr) != (nthr == 0) || nthr < 0 || nthr > 3) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;
  const int padval = bits == 1 ? 1 : 3;
  PackedArgs p = {};
  p.a = static_cast<const uint32_t*>(a);
  p.w = static_cast<const uint32_t*>(w);
  p.thr = static_cast<const int32_t*>(thr);
  p.out = out;
  p.m = m;
  p.kw = kw;
  p.n = n;
  p.k = k;
  p.nthr = nthr;
  p.pad_term = (kw * per_word - k) * padval * padval;
  p.a_vec = reinterpret_cast<uintptr_t>(a) % kVec == 0;
  const uintptr_t out_addr = reinterpret_cast<uintptr_t>(out);
  p.out_vec = thr != nullptr ? n % kVec == 0 && out_addr % kVec == 0
                             : n % 2 == 0 && out_addr % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (popc) return launch_arm<kPopc>(p, s);
  return bits == 1 ? launch_arm<kDecode1>(p, s) : launch_arm<kDecode2>(p, s);
}

}  // extern "C"
