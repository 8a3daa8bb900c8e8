// The seven Mosaic probes: one-primitive kernels, one entry each
// (bnn_probe_<name>).
//
// Replaces the probe functions of tools/mosaic_probes.py (probe_lane_concat,
// probe_scratch_lane_store, probe_mid_dim_index, probe_pool_reshape_max,
// probe_strided_row_slice, probe_lane_slice_64, probe_int32_acc_reshape). On
// the TPU each one asked whether its Mosaic compiler lowers one vector
// primitive: lane concatenation, stores at 64-lane offsets into a VMEM
// scratch, reshapes across the sublane split, strided row slices, lane
// windows. None of those is a question on Hopper, so each kernel computes the
// probe's function in the GPU's own terms instead of carrying its tiles over.
//
// lane_concat and scratch_lane_store compute the same shifted-row int8 dot,
//   out[r, o] = Σ_{i<taps} Σ_{ch<C} x[r+i, ch] · w[i·C + ch, o],
// the heart of conv_chain_vmem, on the int8 tensor cores: mma_tile.cuh's
// warp item (32 rows × 64 columns, item_mma on mma.sync.m16n8k32.s8, both
// operands read by ldmatrix from shared rows pitched ≡ 16 mod 32 bytes).
// One kernel serves both (shifted_dot_kernel); they differ only in how the
// A operand, the patch, is formed, as the two TPU probes do:
// - scratch_lane_store stores the patch into shared memory, the VMEM
//   scratch's counterpart: patch[r, i·C + ch] = x[row0 + r + i, ch], tap i
//   at a C-byte offset (the taps of a row are one run of x: a bulk copy a
//   row where C % 16 == 0 and x is aligned, else byte stores), zero from
//   taps·C up to Kp = round_up(taps·C, 32);
// - lane_concat stages the x rows [row0, row0 + 32 + taps − 1) once, each
//   padded with zeros to Cp = round_up(C, 32), and reads tap i of item row ρ
//   from x-tile row ρ + i: the concatenation becomes an ldmatrix address
//   and no byte is copied twice. So that no k32 step straddles two taps,
//   its weights are staged with each tap's K padded to Cp (Kp = taps·Cp).
// Both stage the block's weight columns transposed, [column][Kp] (a weight
// row per output column, K contiguous, as the B fragments want), zero
// behind K and behind n: the columns' bytes of every w row come by
// cp.async into a raw tile as they lie, then a thread reads 4 rows × 16
// bytes of it, transposes them in registers (__byte_perm) and writes 16
// words (from w's own rows, a byte at a time, where 16-byte copies cannot
// fetch them).
//
// What bounds them on the H100: at JAX's shape (M = 1024, C = 64, taps = 9,
// n = 64) the dot is 75.5 M operations, 0.04 µs at 1,979 int8 TOP/s, and
// the call moves 0.37 MB (x, w, the int32 out), 0.11 µs at 3.35 TB/s: bound
// by bytes, and both far below a launch (about 2 µs under graph replay).
// What a call costs is latency: staging the A tile and the weights, the
// k32 steps, the epilogue, each a chain of dependent waits
// (tools/layer_times.py --only probes times the kernel cut after each).
// The design shortens each chain:
// - a block of 8 warps owns one item of 32 rows × `chunk` columns (row
//   tiles on the grid's x axis, column chunks on its y axis; the chunk is
//   64, halved down to 16 while the grid has fewer blocks than the card has
//   SMs: 32 × 4 = 128 blocks at JAX's shape), and the 8 warps split the
//   item's k32 steps (2 or 3 each at JAX's shape). A 64-column item on 4
//   warps would put 128 warps on 32 SMs; this puts a block on 128 of the
//   132 SMs and halves each thread's share of the staging and the steps;
// - the warps add their partial accumulators into one shared int32 tile
//   with shared-memory atomics, and the tile leaves 16 bytes a thread (a
//   hand-over of the partial sums to owner warps through shared memory,
//   stored with item_store_acc, was slower by more than a launch);
// - the global reads are bulk copies (a row of the A tile each) and 16-byte
//   cp.async (the weights), all in flight together.
// Shared memory is dynamic and sized from the shapes
// (ops/probes.py::dot_smem_bytes computes the same and refuses what exceeds
// the card's 227 KB).
//
// The row gathers (mid_dim_index, strided_row_slice), the lane window and
// the two max reductions (a 2×2 pool on int8 with the byte-wise __vmaxs4, a
// max over groups of 4 int32 rows) are coalesced copy and reduce loops, 16
// bytes a thread where the widths and pointers allow it, else a byte (or
// int32) a thread: nothing but launch and enqueue bounds them (the largest
// moves ~1.2 MB).
#include <cstdint>

#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 1 << 20;       // grid-stride loops cover the rest

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxGrid ? blocks : kMaxGrid);
}

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

__device__ __forceinline__ int4 vmax_s8(int4 a, int4 b) {
  return make_int4(
      static_cast<int>(__vmaxs4(static_cast<unsigned>(a.x),
                                static_cast<unsigned>(b.x))),
      static_cast<int>(__vmaxs4(static_cast<unsigned>(a.y),
                                static_cast<unsigned>(b.y))),
      static_cast<int>(__vmaxs4(static_cast<unsigned>(a.z),
                                static_cast<unsigned>(b.z))),
      static_cast<int>(__vmaxs4(static_cast<unsigned>(a.w),
                                static_cast<unsigned>(b.w))));
}

__device__ __forceinline__ int4 vmax_s32(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                   max(a.w, b.w));
}

// [2·rows, c] viewed as [rows, 2, c]; out = index 0 of the middle dim.
// kVec: 16 bytes a thread (c % 16 == 0, both pointers aligned).
template <bool kVec>
__global__ void mid_dim_index_kernel(const int8_t* __restrict__ x, int rows,
                                     int c, int8_t* __restrict__ out) {
  const int per = kVec ? c / 16 : c;
  const long long total = static_cast<long long>(rows) * per;
  for (long long i = first_index(); i < total; i += grid_stride()) {
    const long long src = (i / per) * 2 * per + i % per;
    if (kVec) {
      reinterpret_cast<int4*>(out)[i] = reinterpret_cast<const int4*>(x)[src];
    } else {
      out[i] = x[src];
    }
  }
}

// 2×2 max pool of int8 [bb, h, w, c] (rows of [bb·h·w, c]) → [bb, h/2, w/2,
// c]. kVec: 16 channels a thread with the byte-wise signed max.
template <bool kVec>
__global__ void pool_reshape_max_kernel(const int8_t* __restrict__ x, int bb,
                                        int h, int w, int c,
                                        int8_t* __restrict__ out) {
  const int oh = h / 2;
  const int ow = w / 2;
  const int per = kVec ? c / 16 : c;
  const long long total = static_cast<long long>(bb) * oh * ow * per;
  for (long long i = first_index(); i < total; i += grid_stride()) {
    const long long j = i % per;
    const long long p = i / per;
    const long long ox = p % ow;
    const long long oy = (p / ow) % oh;
    const long long b = p / (static_cast<long long>(ow) * oh);
    const long long px = (b * h + 2 * oy) * w + 2 * ox;  // top-left pixel
    if (kVec) {
      const int4* x4 = reinterpret_cast<const int4*>(x);
      const int4 top = vmax_s8(x4[px * per + j], x4[(px + 1) * per + j]);
      const int4 bot =
          vmax_s8(x4[(px + w) * per + j], x4[(px + w + 1) * per + j]);
      reinterpret_cast<int4*>(out)[i] = vmax_s8(top, bot);
    } else {
      const int top = max(static_cast<int>(x[px * c + j]),
                          static_cast<int>(x[(px + 1) * c + j]));
      const int bot = max(static_cast<int>(x[(px + w) * c + j]),
                          static_cast<int>(x[(px + w + 1) * c + j]));
      out[i] = static_cast<int8_t>(max(top, bot));
    }
  }
}

// Rows 0, stride, 2·stride, ... of [rows_in, c] (lax.slice with a row
// stride). kVec as for mid_dim_index.
template <bool kVec>
__global__ void strided_row_slice_kernel(const int8_t* __restrict__ x,
                                         int rows_out, int c, int stride,
                                         int8_t* __restrict__ out) {
  const int per = kVec ? c / 16 : c;
  const long long total = static_cast<long long>(rows_out) * per;
  for (long long i = first_index(); i < total; i += grid_stride()) {
    const long long src = (i / per) * stride * per + i % per;
    if (kVec) {
      reinterpret_cast<int4*>(out)[i] = reinterpret_cast<const int4*>(x)[src];
    } else {
      out[i] = x[src];
    }
  }
}

// out = x[:, lo:lo+width] of [m, n]. kVec: n, lo and width multiples of 16
// and both pointers aligned.
template <bool kVec>
__global__ void lane_slice_kernel(const int8_t* __restrict__ x, int m, int n,
                                  int lo, int width,
                                  int8_t* __restrict__ out) {
  const int per = kVec ? width / 16 : width;
  const int in_per = kVec ? n / 16 : n;
  const int off = kVec ? lo / 16 : lo;
  const long long total = static_cast<long long>(m) * per;
  for (long long i = first_index(); i < total; i += grid_stride()) {
    const long long src = (i / per) * in_per + off + i % per;
    if (kVec) {
      reinterpret_cast<int4*>(out)[i] = reinterpret_cast<const int4*>(x)[src];
    } else {
      out[i] = x[src];
    }
  }
}

// int32 [rows·group, c] viewed as [rows, group, c]; out = max over the
// middle dim. kVec: 4 int32 a thread (c % 4 == 0, both pointers aligned).
template <bool kVec>
__global__ void int32_acc_reshape_kernel(const int32_t* __restrict__ x,
                                         int rows, int group, int c,
                                         int32_t* __restrict__ out) {
  const int per = kVec ? c / 4 : c;
  const long long total = static_cast<long long>(rows) * per;
  for (long long i = first_index(); i < total; i += grid_stride()) {
    const long long src = (i / per) * group * per + i % per;
    if (kVec) {
      const int4* x4 = reinterpret_cast<const int4*>(x);
      int4 acc = x4[src];
      for (int g = 1; g < group; ++g) acc = vmax_s32(acc, x4[src + g * per]);
      reinterpret_cast<int4*>(out)[i] = acc;
    } else {
      int32_t acc = x[src];
      for (int g = 1; g < group; ++g) acc = max(acc, x[src + g * per]);
      out[i] = acc;
    }
  }
}

}  // namespace

namespace bnn {
namespace {

constexpr int kDotWarps = 8;                     // a block: one item
constexpr int kDotThreads = 32 * kDotWarps;
constexpr int kRawPitch = kItemCols + kVec;      // bytes a raw weight row
constexpr int kMinChunk = 16;                    // columns a block, at least
// the int32 output tile [32][kTilePitch] the warps' partial sums are added
// into: a pitch ≡ 8 (mod 32) words puts the 8 rows of a fragment's lanes
// in 4 bank octets, so a warp's atomic adds meet at most 2 to a bank
constexpr int kTilePitch = kItemCols + 8;
constexpr int kTileBytes = kItemRows * kTilePitch * 4;

// The shifted-row dot and its shared-memory layout. The staged K is nseg
// segments of seg_pad bytes (a multiple of kMmaK); segment s holds w rows
// s·seg_len + q for q < seg_len and zeros behind: one segment of taps·C for
// scratch_lane_store, one a tap (C of Cp) for lane_concat.
struct DotArgs {
  const int8_t* x;     // [>= m + taps − 1, c]
  const int8_t* w;     // [taps·c, n]
  int32_t* out;        // [m, n]
  int m, c, taps, n;
  int seg_len, seg_pad, nseg;
  int chunk;           // columns a block: 16, 32 or 64
  int gshift;          // log2(chunk / 16): 16-column groups a block
  int a_rows;          // rows of the A tile: 32 (patch) or 32 + taps − 1 (x)
  int a_pitch;         // bytes per A row
  int a_seg;           // bytes from a segment's A to the next one's
  int w_pitch;         // bytes per staged weight column
  int raw_off;         // the raw tile: taps·c rows of kRawPitch bytes
  int tile_off;        // the int32 output tile
  int bar_off;         // the A tile's mbarrier
  int x_vec;           // c % 16 == 0 and x 16-byte aligned: bulk copies
  int w_wide;          // n % 16 == 0 and w 16-byte aligned: cp.async
  int out_vec;         // n % 4 == 0 and out 16-byte aligned
};

// Zero bytes [from, to) of rows [0, real) and [0, to) of rows [real, rows)
// (to: a multiple of 32).
__device__ __forceinline__ void zero_tail(int8_t* s, int rows, int pitch,
                                          int real, int from, int to) {
  const int tail = to - from;
  for (int idx = threadIdx.x; idx < real * tail; idx += blockDim.x) {
    const int r = idx / tail;
    s[r * pitch + from + idx - r * tail] = 0;
  }
  const int vecs = to / kVec;
  for (int idx = threadIdx.x; idx < (rows - real) * vecs;
       idx += blockDim.x) {
    const int r = real + idx / vecs;
    reinterpret_cast<int4*>(s + r * pitch)[idx % vecs] =
        make_int4(0, 0, 0, 0);
  }
}

// Rows [0, count) of the A tile from `count` runs of x: run r is `len`
// bytes at x + (row0 + r)·c. With x_vec one bulk copy a run from warp 0,
// counted off on `bar`; else a warp copies a run a byte a lane at a time.
__device__ __forceinline__ void copy_runs(const DotArgs& p, int8_t* a_s,
                                          int row0, int count, int len,
                                          unsigned bar) {
  const int lane = threadIdx.x & 31;
  if (p.x_vec) {
    if (threadIdx.x >= 32) return;
    if (lane == 0) mbar_expect_tx(bar, count * len);
    __syncwarp();
    for (int r = lane; r < count; r += 32) {
      bulk_copy(smem_addr(a_s + r * p.a_pitch),
                p.x + static_cast<size_t>(row0 + r) * p.c, len, bar);
    }
    return;
  }
  for (int r = threadIdx.x >> 5; r < count; r += kDotWarps) {
    const int8_t* src = p.x + static_cast<size_t>(row0 + r) * p.c;
    for (int k = lane; k < len; k += 32) a_s[r * p.a_pitch + k] = src[k];
  }
}

// scratch_lane_store's patch: a_s[r, i·c + ch] = x[row0 + r + i, ch] for the
// block's real rows, zero from taps·c to Kp and in the rows past m. The taps
// of a row are one run of x, bytes [(row0 + r)·c, + taps·c): tap i lands at
// byte i·c of it.
__device__ __forceinline__ void stage_patch(const DotArgs& p, int8_t* a_s,
                                            int row0, int rows,
                                            unsigned bar) {
  copy_runs(p, a_s, row0, rows, p.taps * p.c, bar);
  zero_tail(a_s, p.a_rows, p.a_pitch, rows, p.taps * p.c, p.seg_pad);
}

// lane_concat's x tile: a_s[r, ch] = x[row0 + r, ch] for the a_rows rows
// from row0 that x must hold (m + taps − 1 in all), zero from c to Cp and
// in the rows past them.
__device__ __forceinline__ void stage_x_rows(const DotArgs& p, int8_t* a_s,
                                             int row0, unsigned bar) {
  const int real = min(p.a_rows, p.m + p.taps - 1 - row0);
  copy_runs(p, a_s, row0, real, p.c, bar);
  zero_tail(a_s, p.a_rows, p.a_pitch, real, p.c, p.seg_pad);
}

// Bytes col..col+3 of w row `row` as one word (byte b: column col + b),
// loaded a byte at a time; zero for row −1 and past n.
__device__ __forceinline__ uint32_t weight_word(const DotArgs& p, int row,
                                                int col) {
  if (row < 0 || col >= p.n) return 0u;
  const int8_t* src = p.w + static_cast<size_t>(row) * p.n + col;
  uint32_t v = 0;
#pragma unroll 1
  for (int b = 0; b < 4 && col + b < p.n; ++b) {
    v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + b)))
         << (8 * b);
  }
  return v;
}

// Bytes col..col+15 of w row `row`, the same way, as four words.
__device__ __forceinline__ uint4 weight_row16(const DotArgs& p, int row,
                                              int col) {
  return make_uint4(weight_word(p, row, col), weight_word(p, row, col + 4),
                    weight_word(p, row, col + 8),
                    weight_word(p, row, col + 12));
}

// Where 16-column group c16 of w row s lies in the raw tile: rows of
// kRawPitch bytes, the groups of a row rotated by (s >> 3) & 3 so that the
// 8 lanes of a quarter warp, reading group c16 of rows 4·k4 + r for 8
// consecutive k4, meet 8 different 16-byte bank groups.
__device__ __forceinline__ int raw_offset(int s, int c16) {
  return s * kRawPitch + kVec * (c16 ^ ((s >> 3) & 3));
}

// The block's columns of all taps·c rows of w into the raw tile as they
// lie (16-byte cp.async; zero past n): w_wide only.
__device__ __forceinline__ void stage_raw_w(const DotArgs& p, int8_t* raw,
                                            int nc0) {
  const unsigned dst = smem_addr(raw);
  const int groups = 1 << p.gshift;
  for (int idx = threadIdx.x; idx < (p.taps * p.c) << p.gshift;
       idx += blockDim.x) {
    const int s = idx >> p.gshift;
    const int c16 = idx & (groups - 1);
    const int col = nc0 + c16 * kVec;
    if (col < p.n) {
      cp_async16(dst + raw_offset(s, c16),
                 p.w + static_cast<size_t>(s) * p.n + col);
    } else {
      *reinterpret_cast<int4*>(raw + raw_offset(s, c16)) =
          make_int4(0, 0, 0, 0);
    }
  }
}

// A 4 × 4 byte block (word r: K row r, byte b: column b), transposed into
// four words of w_s (column b's row, bytes: K rows 0..3), pw words apart.
__device__ __forceinline__ void store_columns(uint32_t* dst, int pw,
                                              uint32_t r0, uint32_t r1,
                                              uint32_t r2, uint32_t r3) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);   // bytes 0, 1
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);   // bytes 2, 3
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  dst[0] = __byte_perm(lo01, lo23, 0x5410);
  dst[pw] = __byte_perm(lo01, lo23, 0x7632);
  dst[2 * pw] = __byte_perm(hi01, hi23, 0x5410);
  dst[3 * pw] = __byte_perm(hi01, hi23, 0x7632);
}

constexpr int kStageBatch = 3;     // units a thread reads before it stores

// The block's chunk of columns [nc0, nc0 + chunk) of w into w_s,
// transposed: row n of w_s holds column nc0 + n along the staged K, zero
// past n. A unit is 4 K rows × 16 columns: four 16-byte reads, transposed
// in registers, sixteen words of w_s. The 32 lanes of a warp take 32
// consecutive k4 of one 16-column group, so their stores fall in 32 banks.
// kRaw: the rows are read from the raw tile (conflict-free), kStageBatch
// units a thread before it stores any; else from w itself, a byte at a
// time, a unit at a time.
template <bool kRaw>
__device__ __forceinline__ void stage_weights_t(const DotArgs& p, int8_t* w_s,
                                                const int8_t* raw, int nc0) {
  constexpr int kBatch = kRaw ? kStageBatch : 1;
  const int k4s = p.nseg * p.seg_pad / 4;
  const int units = ((k4s + 31) / 32 * 32) << p.gshift;
  const int pw = p.w_pitch / 4;
  uint32_t* const ws = reinterpret_cast<uint32_t*>(w_s);
#pragma unroll 1
  for (int base = threadIdx.x; base < units; base += kBatch * blockDim.x) {
    uint4 v[kBatch][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = base + b * blockDim.x;
      const int k4 = ((u >> 5) >> p.gshift) * 32 + (u & 31);
      const int c16 = (u >> 5) & ((1 << p.gshift) - 1);
      // the unit's 4 K rows lie in one segment (seg_pad % 32 == 0)
      const int seg = 4 * k4 / p.seg_pad;
      const int q = 4 * k4 - seg * p.seg_pad;
      const bool live = u < units && k4 < k4s;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = live && q + r < p.seg_len ? seg * p.seg_len + q + r
                                                  : -1;
        if (kRaw) {
          v[b][r] = row < 0 ? make_uint4(0u, 0u, 0u, 0u)
                            : *reinterpret_cast<const uint4*>(
                                  raw + raw_offset(row, c16));
        } else {
          v[b][r] = weight_row16(p, row, nc0 + c16 * kVec);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int u = base + b * blockDim.x;
      const int k4 = ((u >> 5) >> p.gshift) * 32 + (u & 31);
      if (u >= units || k4 >= k4s) continue;
      const int c16 = (u >> 5) & ((1 << p.gshift) - 1);
      uint32_t* dst = ws + c16 * 16 * pw + k4;
      store_columns(dst, pw, v[b][0].x, v[b][1].x, v[b][2].x, v[b][3].x);
      store_columns(dst + 4 * pw, pw, v[b][0].y, v[b][1].y, v[b][2].y,
                    v[b][3].y);
      store_columns(dst + 8 * pw, pw, v[b][0].z, v[b][1].z, v[b][2].z,
                    v[b][3].z);
      store_columns(dst + 12 * pw, pw, v[b][0].w, v[b][1].w, v[b][2].w,
                    v[b][3].w);
    }
  }
}

// Block (blockIdx.x, blockIdx.y): output rows [32·x, +32) × columns
// [chunk·y, +chunk), one warp item whose n8 blocks past the chunk stay
// empty. kConcat: lane_concat's x tile, else scratch_lane_store's patch.
template <bool kConcat>
__global__ void __launch_bounds__(kDotThreads)
shifted_dot_kernel(const DotArgs p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kItemRows;
  const int nc0 = blockIdx.y * p.chunk;
  const int rows = min(kItemRows, p.m - row0);
  const int cols = min(p.chunk, p.n - nc0);
  int8_t* const a_s = smem;
  int8_t* const w_s = smem + p.a_rows * p.a_pitch;
  int8_t* const raw = smem + p.raw_off;
  int32_t* const tile = reinterpret_cast<int32_t*>(smem + p.tile_off);
  const unsigned bar = smem_addr(smem + p.bar_off);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The A tile by bulk copies and the raw weights by cp.async, all in
  // flight at once; then the weights transposed from the raw tile.
  // (Weights that 16-byte copies cannot fetch are transposed from device
  // memory meanwhile.)
  if constexpr (kConcat) {
    stage_x_rows(p, a_s, row0, bar);
  } else {
    stage_patch(p, a_s, row0, rows, bar);
  }
  if (p.w_wide) stage_raw_w(p, raw, nc0);
  cp_async_commit();
  if (!p.w_wide) stage_weights_t<false>(p, w_s, raw, nc0);
  for (int i = threadIdx.x; i < kItemRows * kTilePitch / 4; i += blockDim.x) {
    reinterpret_cast<int4*>(tile)[i] = make_int4(0, 0, 0, 0);
  }
  cp_async_wait<0>();
  if (p.x_vec) mbar_wait(bar, 0);
  __syncthreads();
  if (p.w_wide) {
    stage_weights_t<true>(p, w_s, raw, nc0);
    __syncthreads();
  }

  // This warp's share of the item's k32 steps, a segment at a time: the
  // A addresses of segment s lie s·a_seg bytes on (lane_concat: s rows
  // down, the tap's shift), the B addresses run on through the staged K.
  const int seg_steps = p.seg_pad / kMmaK;
  const int steps = p.nseg * seg_steps;
  const int s_end = (warp + 1) * steps / kDotWarps;
  unsigned a_base[2], b_base[4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    a_base[mb] = smem_addr(a_s) + (16 * mb + a_lane_row(lane)) * p.a_pitch +
                 a_lane_k(lane);
  }
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    b_base[jp] = smem_addr(w_s) + (16 * jp + b_lane_col(lane)) * p.w_pitch +
                 b_lane_k(lane);
  }
  ItemAcc acc;
  item_clear(acc);
  for (int s = warp * steps / kDotWarps; s < s_end;) {
    const int seg = s / seg_steps;
    const int end = min(s_end, (seg + 1) * seg_steps);
    const unsigned a_off = seg * p.a_seg + (s - seg * seg_steps) * kMmaK;
    unsigned a_addr[2], b_addr[4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) a_addr[mb] = a_base[mb] + a_off;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) b_addr[jp] = b_base[jp] + s * kMmaK;
    item_mma(acc, a_addr, b_addr, end - s, cols);
    s = end;
  }

  // The warps' partial sums, added into the shared output tile (fragment
  // layout of mma_tile.cuh: c0, c1 = row g, columns 2t, 2t+1; c2, c3 = row
  // g + 8), then stored 16 bytes a thread, rows and columns past the
  // output left out.
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j >= cols) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        atomicAdd(tile + (16 * mb + 8 * (e >> 1) + g) * kTilePitch + 8 * j +
                      2 * t + (e & 1),
                  acc.c[mb][j][e]);
      }
    }
  __syncthreads();
  const int quads = p.chunk / 4;
  for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
    const int r = i >> (p.gshift + 2);
    const int c = (i & (quads - 1)) * 4;
    if (c >= cols) continue;
    const int4 v = *reinterpret_cast<const int4*>(tile + r * kTilePitch + c);
    int32_t* o = p.out + static_cast<size_t>(row0 + r) * p.n + nc0 + c;
    if (p.out_vec && c + 4 <= cols) {
      *reinterpret_cast<int4*>(o) = v;
    } else {
      o[0] = v.x;
      if (c + 1 < cols) o[1] = v.y;
      if (c + 2 < cols) o[2] = v.z;
      if (c + 3 < cols) o[3] = v.w;
    }
  }
}

// x: int8 [>= m + taps − 1, c]; w: int8 [taps·c, n]; out: int32 [m, n].
// Shared memory: the A tile, 64 staged weight columns, the raw tile, the
// output tile and an mbarrier, whatever the chunk;
// ops/probes.py::dot_smem_bytes mirrors it. The chunk: 64 columns, halved
// (to 16 at least) while the grid has fewer blocks than the card has SMs.
template <bool kConcat>
int launch_shifted_dot(const void* x, int m, int c, const void* w, int taps,
                       int n, void* out, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (c <= 0 || taps <= 0 || (n + kMinChunk - 1) / kMinChunk > 65535) {
    return cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  DotArgs p = {};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.out = static_cast<int32_t*>(out);
  p.m = m;
  p.c = c;
  p.taps = taps;
  p.n = n;
  if (kConcat) {
    p.seg_len = c;
    p.seg_pad = round_up(c, kMmaK);
    p.nseg = taps;
    p.a_rows = kItemRows + taps - 1;
    p.a_pitch = padded_pitch(p.seg_pad);
    p.a_seg = p.a_pitch;               // tap i: i rows down
  } else {
    p.seg_len = taps * c;
    p.seg_pad = round_up(taps * c, kMmaK);
    p.nseg = 1;
    p.a_rows = kItemRows;
    p.a_pitch = padded_pitch(p.seg_pad);
    p.a_seg = p.seg_pad;
  }
  const long long tiles = (m + kItemRows - 1) / kItemRows;
  p.chunk = kItemCols;
  p.gshift = 2;
  while (p.chunk > kMinChunk &&
         tiles * ((n + p.chunk - 1) / p.chunk) < sms) {
    p.chunk /= 2;
    --p.gshift;
  }
  p.w_pitch = padded_pitch(p.nseg * p.seg_pad);
  p.raw_off = p.a_rows * p.a_pitch + kItemCols * p.w_pitch;
  const size_t tile_off = static_cast<size_t>(p.raw_off) +
                          static_cast<size_t>(taps) * c * kRawPitch;
  const size_t smem = tile_off + kTileBytes + 16;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  p.tile_off = static_cast<int>(tile_off);
  p.bar_off = p.tile_off + kTileBytes;
  p.x_vec = c % kVec == 0 && reinterpret_cast<uintptr_t>(x) % kVec == 0;
  p.w_wide = n % kVec == 0 && reinterpret_cast<uintptr_t>(w) % kVec == 0;
  p.out_vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % kVec == 0;
  err = allow_smem(shifted_dot_kernel<kConcat>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles),
                  (n + p.chunk - 1) / p.chunk);
  shifted_dot_kernel<kConcat><<<grid, kDotThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bnn

// Launch kernel<true> (16-byte path) or kernel<false>, then report the
// launch's error.
#define BNN_LAUNCH_VEC(vec, kernel, grid, block, smem, stream, ...)       \
  do {                                                                    \
    if (vec) {                                                            \
      kernel<true><<<grid, block, smem, stream>>>(__VA_ARGS__);           \
    } else {                                                              \
      kernel<false><<<grid, block, smem, stream>>>(__VA_ARGS__);          \
    }                                                                     \
    return cudaGetLastError();                                            \
  } while (0)

extern "C" {

// x: int8 [>= m + taps − 1, c]; w: int8 [taps·c, n]; out: int32 [m, n].
int bnn_probe_lane_concat(const void* x, int m, int c, const void* w,
                          int taps, int n, void* out, void* stream) {
  return bnn::launch_shifted_dot<true>(x, m, c, w, taps, n, out,
                                       static_cast<cudaStream_t>(stream));
}

// The same arguments and function as bnn_probe_lane_concat.
int bnn_probe_scratch_lane_store(const void* x, int m, int c, const void* w,
                                 int taps, int n, void* out, void* stream) {
  return bnn::launch_shifted_dot<false>(x, m, c, w, taps, n, out,
                                        static_cast<cudaStream_t>(stream));
}

// x: int8 [2·rows, c]; out: int8 [rows, c].
int bnn_probe_mid_dim_index(const void* x, int rows, int c, void* out,
                            void* stream) {
  const bool vec = c % 16 == 0 && aligned16(x) && aligned16(out);
  const long long total = static_cast<long long>(rows) * (vec ? c / 16 : c);
  if (total <= 0) return cudaSuccess;
  BNN_LAUNCH_VEC(vec, mid_dim_index_kernel, grid_for(total), kThreads, 0,
                 static_cast<cudaStream_t>(stream),
                 static_cast<const int8_t*>(x), rows, c,
                 static_cast<int8_t*>(out));
}

// x: int8 [bb·h·w, c] with h, w even; out: int8 [bb·(h/2)·(w/2), c].
int bnn_probe_pool_reshape_max(const void* x, int bb, int h, int w, int c,
                               void* out, void* stream) {
  if (h % 2 || w % 2) return cudaErrorInvalidValue;
  const bool vec = c % 16 == 0 && aligned16(x) && aligned16(out);
  const long long total = static_cast<long long>(bb) * (h / 2) * (w / 2) *
                          (vec ? c / 16 : c);
  if (total <= 0) return cudaSuccess;
  BNN_LAUNCH_VEC(vec, pool_reshape_max_kernel, grid_for(total), kThreads, 0,
                 static_cast<cudaStream_t>(stream),
                 static_cast<const int8_t*>(x), bb, h, w, c,
                 static_cast<int8_t*>(out));
}

// x: int8 [rows_in, c]; out: int8 [ceil(rows_in / stride), c].
int bnn_probe_strided_row_slice(const void* x, int rows_in, int c,
                                int stride, void* out, void* stream) {
  if (stride < 1) return cudaErrorInvalidValue;
  const int rows_out = (rows_in + stride - 1) / stride;
  const bool vec = c % 16 == 0 && aligned16(x) && aligned16(out);
  const long long total =
      static_cast<long long>(rows_out) * (vec ? c / 16 : c);
  if (total <= 0) return cudaSuccess;
  BNN_LAUNCH_VEC(vec, strided_row_slice_kernel, grid_for(total), kThreads,
                 0, static_cast<cudaStream_t>(stream),
                 static_cast<const int8_t*>(x), rows_out, c, stride,
                 static_cast<int8_t*>(out));
}

// x: int8 [m, n]; out: int8 [m, width] = x[:, lo:lo+width].
int bnn_probe_lane_slice_64(const void* x, int m, int n, int lo, int width,
                            void* out, void* stream) {
  if (lo < 0 || width < 0 || lo + width > n) return cudaErrorInvalidValue;
  const bool vec = n % 16 == 0 && lo % 16 == 0 && width % 16 == 0 &&
                   aligned16(x) && aligned16(out);
  const long long total =
      static_cast<long long>(m) * (vec ? width / 16 : width);
  if (total <= 0) return cudaSuccess;
  BNN_LAUNCH_VEC(vec, lane_slice_kernel, grid_for(total), kThreads, 0,
                 static_cast<cudaStream_t>(stream),
                 static_cast<const int8_t*>(x), m, n, lo, width,
                 static_cast<int8_t*>(out));
}

// x: int32 [rows·group, c]; out: int32 [rows, c], the max over each group.
int bnn_probe_int32_acc_reshape(const void* x, int rows, int group, int c,
                                void* out, void* stream) {
  if (group < 1) return cudaErrorInvalidValue;
  const bool vec = c % 4 == 0 && aligned16(x) && aligned16(out);
  const long long total = static_cast<long long>(rows) * (vec ? c / 4 : c);
  if (total <= 0) return cudaSuccess;
  BNN_LAUNCH_VEC(vec, int32_acc_reshape_kernel, grid_for(total), kThreads, 0,
                 static_cast<cudaStream_t>(stream),
                 static_cast<const int32_t*>(x), rows, group, c,
                 static_cast<int32_t*>(out));
}

}  // extern "C"
