// Shared device code of the tensor-core kernels (conv_tile.cuh under
// conv_chain.cu and conv_direct.cu, dense_block.cu, dense_chain.cu,
// packed_matmul.cu, mosaic_probes.cu's shifted-row dot): int8 × int8 →
// int32 warp tiles on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, with
// both operands read from shared memory by ldmatrix, cp.async staging, and
// the MultiThreshold epilogue run on the accumulator fragments (or, for a
// conv that a 2×2 max-pool follows, on each window's largest of them:
// item_store_pooled; for a ResNet block's closing conv, after its shortcut
// joins them: item_add_residual).
// (packed_matmul.cu's popcount arm runs the same item on the 1-bit
// m16n8k256, whose fragments are these counted in bytes; it and the decode
// arm read A from packed words.)
//
// Under the ports of bnn_pynq_tpu/ops/conv_stack.py::conv_chain_vmem and
// ::dense_block, ops/conv_direct.py::conv2d_direct and ::conv_chain_direct,
// ops/fused_mlp.py::fused_mlp_forward, ops/matmul.py::packed_matmul, and
// tools/mosaic_probes.py::probe_lane_concat and ::probe_scratch_lane_store.
// All are bound by operations or bytes far below what the CUDA cores reach
// (the bounds stand in the .cu files), so the dots run on the tensor cores
// and every operand byte is fetched from L2 once per block tile, not once
// per thread.
//
// mma.sync alone reaches 1,260 TOP/s on an NVIDIA H100 80GB HBM3 at 700.00 W
// (tools/layer_times.py), 64 % of the published 1,979: the ceiling of these
// kernels short of wgmma. The 1-bit m16n8k256 with .and.popc runs at the same
// instruction rate, 10,100 binary TOP/s; with .xor.popc at a tenth of it.
//
// A warp item is a 32-row × 64-column tile (2 m16 × 8 n8 blocks, 64 int32
// accumulators a thread). Per k32 step it issues 2 + 4 ldmatrix.x4 and 16
// mma: each A fragment is reused for 8 column blocks, each B fragment for
// 2 row blocks.
//
// Fragment layout of m16n8k32 (g = lane / 4, t = lane % 4):
//   A (row-major [16, 32] int8), 4 registers of 4 bytes:
//     a0 = A[g][4t..4t+3]      a1 = A[g+8][4t..4t+3]
//     a2 = A[g][16+4t..]       a3 = A[g+8][16+4t..]
//   B (column-major: [8, 32] int8 with K contiguous, i.e. a weight row per
//     output column), 2 registers:
//     b0 = W[g][4t..4t+3]      b1 = W[g][16+4t..]
//   C/D int32: c0, c1 = C[g][2t], C[g][2t+1]; c2, c3 = C[g+8][2t], [2t+1]
// ldmatrix (8 rows × 16 bytes per matrix; lane l of matrix q = l / 8 gives
// the address of row l % 8; every lane receives bytes 4t..4t+3 of row g)
// delivers exactly these registers:
//   A: matrices (rows 0-7, k 0-15), (rows 8-15, k 0-15), (rows 0-7,
//      k 16-31), (rows 8-15, k 16-31) → a0..a3
//   B: for a pair of n8 blocks j, j+1: (j, k 0-15), (j, k 16-31),
//      (j+1, k 0-15), (j+1, k 16-31) → b0, b1 of j and of j+1
//
// Shared-memory rows (activation pixels or rows, weight rows) have a pitch
// ≡ 16 (mod 32) bytes: the 8 row addresses of one ldmatrix then fall in 8
// different 16-byte bank groups, so no load conflicts.
//
// Codes without a decode pass: an activation code c stands for the level
// 2c − off (off = 1 or 3), so  Σ level·w = 2·Σ c·w − off·Σ w.  The kernels
// copy raw codes into shared memory with cp.async, run the mma on them, and
// the epilogue corrects for it with the per-column weight sums prepared on
// the host (models/params.py), folded into the thresholds once per block
// (stage_thresholds). Exact. Unsigned 4-bit codes (0..15, abits 4) are
// their own levels: the launchers take them as levels, with no correction.
//
// 15 thresholds (4-bit codes) are searched, not each compared: the code is
// the count of a column's thresholds at or below the accumulator, which does
// not depend on their order, so the host sorts each column's 15 ascending
// (models/params.py) and the epilogue finds the count in 4 compares,
//   pos += acc >= t[pos + s − 1] ? s : 0   for s = 8, 4, 2, 1,
// exact with ties and with the never / always sentinels (block_codes). The
// last three reads depend on the accumulator, so the 8 lanes that share a
// column (one per row g) may read 8 different thresholds of it at once. A
// 15-row table is staged with a row pitch ≡ 2 (mod 32) words and, within
// each 8 columns, column 2t + c in slot 4c + t (search_slot): threshold k
// of a lane's column c then lies in bank 2k + t + 4c (+ a constant), so the
// 4 column groups t × the thresholds one step can read (k ≡ s − 1 mod 2s)
// fall in 32 different banks, and no search step waits on a bank conflict.
#pragma once

#include "common.cuh"

namespace bnn {

constexpr int kMmaK = 32;        // bytes of K per mma
constexpr int kItemRows = 32;    // rows of a warp item (2 m16 blocks)
constexpr int kItemCols = 64;    // columns of a warp item (8 n8 blocks)
constexpr int kPitchPad = 16;    // added to a multiple of 32 → ≡ 16 (mod 32)
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers and bulk copies (cp.async.bulk, completion counted in bytes on
// an mbarrier).
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also announces `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from device to
// shared memory; the barrier counts them off as they land.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a · b, exact int32 (no saturation).
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp item's accumulators: [m16 block][n8 block][c0..c3].
struct ItemAcc {
  int c[2][8][4];
};

__device__ __forceinline__ void item_clear(ItemAcc& acc) {
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.c[mb][j][e] = 0;
}

// The lane's ldmatrix row of m16 block mb within an item: item row
// 16·mb + a_lane_row(lane), at K offset a_lane_k(lane).
__device__ __forceinline__ int a_lane_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_lane_k(int lane) { return (lane >> 4) * 16; }
// The lane's ldmatrix row of the n8 block pair jp: item column
// 16·jp + b_lane_col(lane), at K offset b_lane_k(lane).
__device__ __forceinline__ int b_lane_col(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_lane_k(int lane) {
  return ((lane >> 3) & 1) * 16;
}

// `steps` k32 steps of a warp item. a_addr[mb] / b_addr[jp]: the lane's
// shared-memory byte addresses (row base + its K offset) at the first step;
// both advance 32 bytes a step. ncols: the item's real columns (1..64). A
// full item loads its four B fragments into registers of their own before
// the 16 mma, so no load waits for an mma to release its registers; a
// narrower item skips the n8 block pairs wholly past ncols (warp-uniform).
__device__ __forceinline__ void item_mma(ItemAcc& acc,
                                         const unsigned (&a_addr)[2],
                                         const unsigned (&b_addr)[4],
                                         int steps, int ncols) {
  if (ncols == kItemCols) {
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      const unsigned off = static_cast<unsigned>(s) * kMmaK;
      unsigned a[2][4], b[4][4];
      ldmatrix_x4(a[0], a_addr[0] + off);
      ldmatrix_x4(a[1], a_addr[1] + off);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) ldmatrix_x4(b[jp], b_addr[jp] + off);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          mma_s8(acc.c[mb][2 * jp], a[mb], b[jp][0], b[jp][1]);
          mma_s8(acc.c[mb][2 * jp + 1], a[mb], b[jp][2], b[jp][3]);
        }
      }
    }
    return;
  }
  for (int s = 0; s < steps; ++s) {
    const unsigned off = static_cast<unsigned>(s) * kMmaK;
    unsigned a[2][4];
    ldmatrix_x4(a[0], a_addr[0] + off);
    ldmatrix_x4(a[1], a_addr[1] + off);
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

// What the epilogue needs of a layer.
struct EpilogueArgs {
  const int32_t* thr;    // [nthr, n_out]
  const int32_t* wsum;   // [n_out] column sums of the weight levels
  int nthr;
  int n_out;
  int level_off;         // 1 or 3 (abits 1, 2); 0 for 4-bit codes
  int codes_in;          // the A operand held 1- or 2-bit codes, not levels
};

constexpr int kStagePitch = kItemCols + kPitchPad;        // 80 bytes
constexpr int kStageBytes = 16 * kStagePitch;             // one m16 block
constexpr int kThrNever = 0x7fffffff;
constexpr int kSearchSkew = 2;   // words a searched row adds to its columns

// The row pitch, in words, of a searched table staged over cols_pad
// columns (a multiple of 32): ≡ 2 (mod 32).
__host__ __device__ constexpr int search_pitch(int cols_pad) {
  return cols_pad + kSearchSkew;
}

// int32 words of a staged table of `rows` thresholds over cols_pad columns
// (WIDE: searched), rounded up to 16 bytes so that what the kernel stages
// after it stays aligned.
template <bool WIDE>
__host__ __device__ inline int thr_words(int rows, int cols_pad) {
  return WIDE ? round_up(rows * search_pitch(cols_pad), 4) : rows * cols_pad;
}

// The slot of staged column n (searched tables): 2t + c → 4c + t within
// each 8 columns.
__device__ __forceinline__ int search_slot(int n) {
  return (n & ~7) | ((n & 1) << 2) | ((n >> 1) & 3);
}

// Shared memory the epilogue of a block needs: the folded thresholds of
// `cols` staged columns (rounded up to whole items) and one output staging
// buffer per warp.
inline size_t epilogue_smem(int nthr, int cols, int warps = kWarps) {
  const int cols_pad = round_up(cols, kItemCols);
  const int words = nthr == kMaxThr ? thr_words<true>(nthr, cols_pad)
                                    : thr_words<false>(nthr, cols_pad);
  return static_cast<size_t>(words) * 4 +
         static_cast<size_t>(warps) * kStageBytes;
}

// Stage the thresholds of columns [nc0, nc0 + ncols) in shared memory, as
// thr_s[k · cols_pad + n] (WIDE: thr_s[k · search_pitch + search_slot(n)]),
// folded onto the raw accumulator: with codes in,
//   2·acc − off·wsum ≥ thr  ⟺  acc ≥ ceil((thr + off·wsum) / 2),
// in 64 bits and clamped (|acc| < 2^24, so a clamped threshold compares as
// the true one; the fold keeps a column's order). Columns past ncols never
// pass. The caller synchronizes. `threads`: how many of the block's first
// threads take part. WIDE: a thread a column, its 15 loads issued before
// any store (a store to shared memory may alias a later load for all the
// compiler knows, which would serialize them).
template <bool WIDE = false>
__device__ __forceinline__ void stage_thresholds(int32_t* thr_s, int cols_pad,
                                                 const EpilogueArgs& e,
                                                 int nc0, int ncols,
                                                 int threads) {
  if constexpr (WIDE) {
    const int pitch = search_pitch(cols_pad);
    for (int n = threadIdx.x; n < cols_pad; n += threads) {
      long long x[kMaxThr];
#pragma unroll
      for (int k = 0; k < kMaxThr; ++k) {
        x[k] = n < ncols ? __ldg(e.thr + k * e.n_out + nc0 + n) : kThrNever;
      }
      const long long w = n < ncols && e.codes_in
                              ? static_cast<long long>(e.level_off) *
                                    __ldg(e.wsum + nc0 + n)
                              : 0;
      int32_t* const col = thr_s + search_slot(n);
#pragma unroll
      for (int k = 0; k < kMaxThr; ++k) {
        long long v = x[k];
        if (n < ncols && e.codes_in) v = (v + w + 1) >> 1;
        v = v > kThrNever ? kThrNever : (v < -kThrNever - 1 ? -kThrNever - 1 : v);
        col[k * pitch] = static_cast<int32_t>(v);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < e.nthr * cols_pad; i += threads) {
    const int k = i / cols_pad;
    const int n = i - k * cols_pad;
    long long x = kThrNever;
    if (n < ncols) {
      x = __ldg(e.thr + k * e.n_out + nc0 + n);
      if (e.codes_in) {
        x = (x + static_cast<long long>(e.level_off) *
                     __ldg(e.wsum + nc0 + n) + 1) >> 1;
      }
      x = x > kThrNever ? kThrNever : (x < -kThrNever - 1 ? -kThrNever - 1 : x);
    }
    thr_s[i] = static_cast<int32_t>(x);
  }
}

// The lane's four codes of n8 block j of m16 block mb: [h][c] for item row
// 16·mb + 8·h + g, column 8·j + 2·t + c.
__device__ __forceinline__ void block_codes_step(const ItemAcc& acc, int mb,
                                                 int j, const int32_t* thr_k,
                                                 int (&code)[2][2]) {
  const int2 th = *reinterpret_cast<const int2*>(thr_k + 8 * j);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    code[h][0] += acc.c[mb][j][2 * h] >= th.x ? 1 : 0;
    code[h][1] += acc.c[mb][j][2 * h + 1] >= th.y ? 1 : 0;
  }
}

// 1-3 thresholds unrolled whole, each compared. 15 (4-bit codes), sorted in
// each column: searched in 4 steps. thr_lane: the lane's first column at
// threshold 0 (1-3: column 2t, its second the next word; 15: slot t, its
// second 4 slots on); cols_pad: the words between thresholds.
template <int NTHR>
__device__ __forceinline__ void block_codes(const ItemAcc& acc, int mb, int j,
                                            const int32_t* thr_lane,
                                            int cols_pad, int (&code)[2][2]) {
  code[0][0] = code[0][1] = code[1][0] = code[1][1] = 0;
  if constexpr (NTHR <= 3) {
#pragma unroll
    for (int k = 0; k < NTHR; ++k) {
      block_codes_step(acc, mb, j, thr_lane + k * cols_pad, code);
    }
  } else {
    static_assert(NTHR == 15, "a 4-step search covers 15 thresholds");
    // in bytes, so that a read's address is one multiply-add of pos
    const int pb = 4 * cols_pad;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const char* const t0 = reinterpret_cast<const char*>(
          thr_lane + 8 * j + 4 * c);
      const char* const t1 = t0 + pb;
      const char* const t3 = t0 + 3 * pb;
      const int mid = *reinterpret_cast<const int*>(t0 + 7 * pb);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = acc.c[mb][j][2 * h + c];
        int pos = a >= mid ? 8 : 0;
        pos += a >= *reinterpret_cast<const int*>(t3 + pos * pb) ? 4 : 0;
        pos += a >= *reinterpret_cast<const int*>(t1 + pos * pb) ? 2 : 0;
        pos += a >= *reinterpret_cast<const int*>(t0 + pos * pb) ? 1 : 0;
        code[h][c] = pos;
      }
    }
  }
}

// Threshold the item's accumulators and store int8 codes.
//   thr_s: the staged thresholds at the item's first column (a multiple of
//     8), cols_pad the table's staged columns (the stride between
//     thresholds; search_pitch of it for 15); stage: this warp's
//     kStageBytes;
//   out + row0 · n_out + col0: the output of item row 0, column 0;
//   rows, cols: the item's real rows (1..32) and columns (1..64).
// Where whole 16-byte runs of a row can be stored (vec: n_out, col0 and
// cols multiples of 16, out aligned), an m16 block's codes are gathered in
// the staging buffer and leave as 16-byte stores, 64 contiguous bytes a
// row; else each lane stores its bytes one by one. NJ: the n8 blocks of the
// item that hold columns (8 unless the caller's items are narrower).
template <int NTHR, int NJ = 8>
__device__ __forceinline__ void item_store_codes_n(
    const ItemAcc& acc, const int32_t* thr_s, int cols_pad, int8_t* stage,
    int8_t* out, int n_out, size_t row0, int rows, int col0, int cols,
    bool vec, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  constexpr bool kSearch = NTHR == kMaxThr;
  const int32_t* thr_lane = thr_s + (kSearch ? t : 2 * t);
  if constexpr (kSearch) cols_pad = search_pitch(cols_pad);
  if (vec) {
    int8_t* st = stage + g * kStagePitch + 2 * t;
    const int r = lane >> 2;                  // this lane's row of a store
    const int c16 = (lane & 3) * kVec;        // ... and its 16-byte run
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        int code[2][2];
        block_codes<NTHR>(acc, mb, j, thr_lane, cols_pad, code);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<uint16_t*>(st + 8 * h * kStagePitch + 8 * j) =
              static_cast<uint16_t>(code[h][0] | (code[h][1] << 8));
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = 16 * mb + 8 * i + r;
        const int4 v = *reinterpret_cast<const int4*>(
            stage + (8 * i + r) * kStagePitch + c16);
        if (rr < rows && c16 < cols) {
          *reinterpret_cast<int4*>(out + (row0 + rr) * n_out + col0 + c16) = v;
        }
      }
      __syncwarp();
    }
    return;
  }
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      int code[2][2];
      block_codes<NTHR>(acc, mb, j, thr_lane, cols_pad, code);
      const int n = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = 16 * mb + 8 * h + g;
        if (rr < rows) {
          int8_t* o = out + (row0 + rr) * n_out + col0 + n;
          if (n < cols) o[0] = static_cast<int8_t>(code[h][0]);
          if (n + 1 < cols) o[1] = static_cast<int8_t>(code[h][1]);
        }
      }
    }
  }
}

// The same with the number of thresholds (1..3) chosen at run time; WIDE:
// kMaxThr of them (4-bit codes). The kernels take WIDE as a template
// argument of their own, so that 1- and 2-bit nets run a kernel compiled
// without the 15-threshold epilogue (common.cuh nthr_ok: no other count).
template <int NJ = 8, bool WIDE = false>
__device__ __forceinline__ void item_store_codes(
    const ItemAcc& acc, const int32_t* thr_s, int cols_pad, int nthr,
    int8_t* stage, int8_t* out, int n_out, size_t row0, int rows, int col0,
    int cols, bool vec, int lane) {
  if constexpr (WIDE) {
    item_store_codes_n<kMaxThr, NJ>(acc, thr_s, cols_pad, stage, out, n_out,
                                    row0, rows, col0, cols, vec, lane);
    return;
  }
  if (nthr == 1) {
    item_store_codes_n<1, NJ>(acc, thr_s, cols_pad, stage, out, n_out, row0,
                              rows, col0, cols, vec, lane);
  } else if (nthr == 2) {
    item_store_codes_n<2, NJ>(acc, thr_s, cols_pad, stage, out, n_out, row0,
                              rows, col0, cols, vec, lane);
  } else {
    item_store_codes_n<3, NJ>(acc, thr_s, cols_pad, stage, out, n_out, row0,
                              rows, col0, cols, vec, lane);
  }
}

// Add a bottleneck block's identity shortcut to the item's accumulators
// before the thresholds: acc[row][col] += r[col]·res[row][col], res the
// block input's unsigned codes [*, n_out] (their own levels; ResNet's
// dense_block.cu kResIdentity), r its int32 multiplier [n_out].
//   res + row0 · n_out + col0, r + col0: item row 0, column 0;
//   rows, cols: the item's real rows (1..32) and columns (1..64);
//   pairs: n_out even and res 2-byte aligned, so a lane's two neighbouring
//     codes come as one 2-byte load.
// Each lane reads the codes of its own accumulators (rows g, g + 8, g + 16,
// g + 24; columns 8j + 2t, + 1); a warp's load of one (j, row block) takes
// 8 bytes of each of 8 rows, and the next three j read the rest of the same
// 32-byte sectors, from L1.
__device__ __forceinline__ void item_add_residual(
    ItemAcc& acc, const int8_t* res, const int32_t* r, int n_out,
    size_t row0, int rows, int col0, int cols, bool pairs, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * t;
    if (n >= cols) continue;
    const bool two = n + 1 < cols;
    const int r0 = __ldg(r + col0 + n);
    const int r1 = two ? __ldg(r + col0 + n + 1) : 0;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = 16 * mb + 8 * h + g;
        if (rr >= rows) continue;
        const int8_t* p = res + (row0 + rr) * n_out + col0 + n;
        int v0, v1 = 0;
        if (pairs && two) {
          const char2 v = __ldg(reinterpret_cast<const char2*>(p));
          v0 = v.x;
          v1 = v.y;
        } else {
          v0 = __ldg(p);
          if (two) v1 = __ldg(p + 1);
        }
        acc.c[mb][j][2 * h] += r0 * v0;
        acc.c[mb][j][2 * h + 1] += r1 * v1;
      }
    }
  }
}

// The 2×2 max-pool of m16 block mb of an item whose rows are windows: item
// row 4w + s is position s of window w. A window's four rows (g, or g + 8,
// for the four g that differ in bits 0-1: windows g / 4 and 2 + g / 4) sit
// in the lanes 4 and 8 apart, so two exchanges with those lanes reduce each
// window; at each a lane keeps half of its n8 blocks and sends the other
// half, so that lane u = g % 4 ends with the window maxima of blocks u and
// u + 4, which it leaves in blocks 0 and 4 of acc (the others then hold
// nothing): 24 shuffles for 32 accumulators, a quarter of them left to
// threshold.
__device__ __forceinline__ void pool_windows(ItemAcc& acc, int mb, int lane) {
  const bool odd = lane & 4;      // bit 0 of u: keeps the odd blocks
  const bool high = lane & 8;     // bit 1 of u: keeps blocks 2 and 3 of 4
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {     // block 2·jp ← block 2·jp + odd
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lo = acc.c[mb][2 * jp][e], hi = acc.c[mb][2 * jp + 1][e];
      const int other = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 4);
      acc.c[mb][2 * jp][e] = max(odd ? hi : lo, other);
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {        // block 4·k ← block 4·k + u
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lo = acc.c[mb][4 * k][e], hi = acc.c[mb][4 * k + 2][e];
      const int other = __shfl_xor_sync(0xffffffffu, high ? lo : hi, 8);
      acc.c[mb][4 * k][e] = max(high ? hi : lo, other);
    }
  }
}

// Pool the item's 2×2 windows, threshold each window's largest accumulator
// and store int8 codes: the code never falls as the accumulator grows (it
// counts the thresholds at or below it, folded onto the raw accumulator
// alike for every row of a column), so the largest accumulator's code is
// the largest of the four codes, exactly. Overwrites acc.
//   thr_s, cols_pad: as item_store_codes_n's;
//   out + win0 · n_out + col0: the output of the item's window 0, column 0;
//   windows, cols: the item's real windows (1..8) and columns (1..64);
//   pairs: n_out is even and out 2-byte aligned, so a lane's two
//     neighbouring codes leave as one 2-byte store (a warp's store then
//     writes 32 contiguous bytes of each of two windows).
template <int NTHR>
__device__ __forceinline__ void item_store_pooled_n(
    ItemAcc& acc, const int32_t* thr_s, int cols_pad, int8_t* out, int n_out,
    size_t win0, int windows, int col0, int cols, bool pairs, int lane) {
  const int t = lane & 3;
  const int u = (lane >> 2) & 3;
  constexpr bool kSearch = NTHR == kMaxThr;
  // block 4k of acc holds block 4k + u: its thresholds lie 8·u columns on
  const int32_t* thr_lane = thr_s + (kSearch ? t : 2 * t) + 8 * u;
  if constexpr (kSearch) cols_pad = search_pitch(cols_pad);
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    pool_windows(acc, mb, lane);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      int code[2][2];
      block_codes<NTHR>(acc, mb, 4 * k, thr_lane, cols_pad, code);
      const int n = 8 * (4 * k + u) + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int w = 4 * mb + 2 * h + (lane >> 4);
        if (w >= windows || n >= cols) continue;
        int8_t* o = out + (win0 + w) * n_out + col0 + n;
        if (pairs && n + 1 < cols) {
          *reinterpret_cast<uint16_t*>(o) =
              static_cast<uint16_t>(code[h][0] | (code[h][1] << 8));
        } else {
          o[0] = static_cast<int8_t>(code[h][0]);
          if (n + 1 < cols) o[1] = static_cast<int8_t>(code[h][1]);
        }
      }
    }
  }
}

// The same with the number of thresholds chosen as item_store_codes does.
template <bool WIDE = false>
__device__ __forceinline__ void item_store_pooled(
    ItemAcc& acc, const int32_t* thr_s, int cols_pad, int nthr,
    int8_t* out, int n_out, size_t win0, int windows, int col0, int cols,
    bool pairs, int lane) {
  if constexpr (WIDE) {
    item_store_pooled_n<kMaxThr>(acc, thr_s, cols_pad, out, n_out, win0,
                                 windows, col0, cols, pairs, lane);
    return;
  }
  if (nthr == 1) {
    item_store_pooled_n<1>(acc, thr_s, cols_pad, out, n_out, win0, windows,
                           col0, cols, pairs, lane);
  } else if (nthr == 2) {
    item_store_pooled_n<2>(acc, thr_s, cols_pad, out, n_out, win0, windows,
                           col0, cols, pairs, lane);
  } else {
    item_store_pooled_n<3>(acc, thr_s, cols_pad, out, n_out, win0, windows,
                           col0, cols, pairs, lane);
  }
}

// The same with every thread of the block taking part.
template <bool WIDE = false>
__device__ __forceinline__ void stage_thresholds(int32_t* thr_s, int cols_pad,
                                                 const EpilogueArgs& e,
                                                 int nc0, int ncols) {
  stage_thresholds<WIDE>(thr_s, cols_pad, e, nc0, ncols, blockDim.x);
}

// For an epilogue that keeps the accumulator: stage, for columns
// [nc0, nc0 + ncols), what the raw accumulator of a dot on codes lacks of
// the true one, Σ level·w = 2·acc − off·wsum, as sub_s[n] = off·wsum (0
// where the A operand held levels, and past ncols). The caller synchronizes.
__device__ __forceinline__ void stage_acc_correction(int32_t* sub_s,
                                                     int cols_pad,
                                                     const EpilogueArgs& e,
                                                     int nc0, int ncols) {
  for (int n = threadIdx.x; n < cols_pad; n += blockDim.x) {
    sub_s[n] = (n < ncols && e.codes_in)
                   ? e.level_off * __ldg(e.wsum + nc0 + n)
                   : 0;
  }
}

// Store the item's true int32 accumulators, mul·acc − sub_s[column] (mul 2
// with codes in, else 1; exact: |Σ| < 2^24).
//   sub_s: the staged corrections at the item's first column;
//   out + row0 · n_out + col0: the output of item row 0, column 0;
//   rows, cols: the item's real rows (1..32) and columns (1..64);
//   pairs: n_out is even and out 8-byte aligned, so a lane's two
//     neighbouring columns leave as one 8-byte store (a quad of lanes then
//     writes 32 contiguous bytes of a row).
__device__ __forceinline__ void item_store_acc(
    const ItemAcc& acc, const int32_t* sub_s, int mul, int32_t* out,
    int n_out, size_t row0, int rows, int col0, int cols, bool pairs,
    int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * t;
      const int2 sub = *reinterpret_cast<const int2*>(sub_s + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = 16 * mb + 8 * h + g;
        if (rr >= rows || n >= cols) continue;
        const int v0 = mul * acc.c[mb][j][2 * h] - sub.x;
        const int v1 = mul * acc.c[mb][j][2 * h + 1] - sub.y;
        int32_t* o = out + (row0 + rr) * n_out + col0 + n;
        if (pairs && n + 1 < cols) {
          *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
        } else {
          o[0] = v0;
          if (n + 1 < cols) o[1] = v1;
        }
      }
    }
  }
}

// The smallest pitch ≥ bytes that is ≡ 16 (mod 32).
inline int padded_pitch(int bytes) {
  return round_up(bytes, kMmaK) + kPitchPad;
}

}  // namespace bnn
