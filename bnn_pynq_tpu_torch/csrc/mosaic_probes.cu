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
// probe's function in the GPU's own terms instead of carrying its tiles over:
// - lane_concat: a thread owns one output (row, column) and gathers the K
//   shifted input rows straight from device memory into registers, 16 bytes
//   at a time, running __dp4a against the weight column;
// - scratch_lane_store: the VMEM scratch becomes shared memory: a block
//   stores its rows' K shifted slices at C-byte column offsets into a
//   [rows, K·C] patch tile, synchronises, and runs the dot from the tile;
// - the row gathers (mid_dim_index, strided_row_slice), the lane window and
//   the two max reductions (a 2×2 pool on int8 with the byte-wise __vmaxs4,
//   a max over groups of 4 int32 rows) are coalesced copy and reduce loops,
//   16 bytes a thread where the widths and pointers allow it, else a byte
//   (or int32) a thread.
//
// What bounds them on the H100: nothing but launch and enqueue. At the
// probes' shapes (M = 1024, C = 64) the largest moves ~1.2 MB and the dots
// run 38 M MACs, a few microseconds of the card; a call reads at the
// enqueue floor. Speed is not their purpose.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 1 << 20;       // grid-stride loops cover the rest
constexpr int kScratchRows = 32;        // rows of a scratch_lane_store tile
constexpr int kScratchSmem = 48 * 1024; // static limit: no opt-in needed

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

// Four consecutive weight rows k..k+3 of one column (row stride n), as the
// signed bytes of one dp4a operand.
__device__ __forceinline__ int weight_column4(const int8_t* p, int n) {
  const uint32_t b0 = static_cast<uint8_t>(p[0]);
  const uint32_t b1 = static_cast<uint8_t>(p[n]);
  const uint32_t b2 = static_cast<uint8_t>(p[2 * n]);
  const uint32_t b3 = static_cast<uint8_t>(p[3 * n]);
  return static_cast<int>(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

__device__ __forceinline__ int dp4a16(int4 a, const int8_t* w, int n,
                                      int acc) {
  acc = __dp4a(a.x, weight_column4(w, n), acc);
  acc = __dp4a(a.y, weight_column4(w + 4LL * n, n), acc);
  acc = __dp4a(a.z, weight_column4(w + 8LL * n, n), acc);
  return __dp4a(a.w, weight_column4(w + 12LL * n, n), acc);
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

// out[r, o] = Σ_{i<taps} Σ_{ch<c} x[r+i, ch] · w[i·c + ch, o]. Block
// (64 columns, 4 rows); kVec: c % 16 == 0 and x 16-byte aligned.
template <bool kVec>
__global__ void lane_concat_kernel(const int8_t* __restrict__ x, int m, int c,
                                   const int8_t* __restrict__ w, int taps,
                                   int n, int32_t* __restrict__ out) {
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= m || col >= n) return;
  int acc = 0;
  for (int i = 0; i < taps; ++i) {
    const int8_t* xr = x + static_cast<long long>(row + i) * c;
    const int8_t* wc = w + static_cast<long long>(i) * c * n + col;
    if (kVec) {
      for (int ch = 0; ch < c; ch += 16) {
        acc = dp4a16(*reinterpret_cast<const int4*>(xr + ch),
                     wc + static_cast<long long>(ch) * n, n, acc);
      }
    } else {
      for (int ch = 0; ch < c; ++ch) {
        acc += static_cast<int>(xr[ch]) *
               static_cast<int>(wc[static_cast<long long>(ch) * n]);
      }
    }
  }
  out[static_cast<long long>(row) * n + col] = acc;
}

// The same function through a shared-memory patch tile [rows, taps·c]: tap
// i of row r is stored at column offset i·c, then each thread runs dots of
// tile rows against weight columns. kVec: c % 16 == 0, x 16-byte aligned.
template <bool kVec>
__global__ void scratch_lane_store_kernel(const int8_t* __restrict__ x, int m,
                                          int c, const int8_t* __restrict__ w,
                                          int taps, int n, int tile_rows,
                                          int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int8_t patch[];
  const int kc = taps * c;
  const int row0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, m - row0);
  if (kVec) {
    const int per = c / 16;
    for (int idx = threadIdx.x; idx < rows * taps * per; idx += blockDim.x) {
      const int j = idx % per;
      const int t = idx / per;
      const int i = t % taps;
      const int r = t / taps;
      reinterpret_cast<int4*>(patch + r * kc + i * c)[j] =
          reinterpret_cast<const int4*>(
              x + static_cast<long long>(row0 + r + i) * c)[j];
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * kc; idx += blockDim.x) {
      const int k = idx % kc;
      const int r = idx / kc;
      patch[idx] = x[static_cast<long long>(row0 + r + k / c) * c + k % c];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
    const int col = idx % n;
    const int r = idx / n;
    const int8_t* pr = patch + r * kc;
    const int8_t* wc = w + col;
    int acc = 0;
    if (kVec) {
      for (int k = 0; k < kc; k += 4) {
        acc = __dp4a(*reinterpret_cast<const int*>(pr + k),
                     weight_column4(wc + static_cast<long long>(k) * n, n),
                     acc);
      }
    } else {
      for (int k = 0; k < kc; ++k) {
        acc += static_cast<int>(pr[k]) *
               static_cast<int>(wc[static_cast<long long>(k) * n]);
      }
    }
    out[static_cast<long long>(row0 + r) * n + col] = acc;
  }
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

// x: int8 [>= m + taps - 1, c]; w: int8 [taps·c, n]; out: int32 [m, n].
int bnn_probe_lane_concat(const void* x, int m, int c, const void* w,
                          int taps, int n, void* out, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  const dim3 block(64, 4);
  const dim3 grid((m + 3) / 4, (n + 63) / 64);
  BNN_LAUNCH_VEC(c % 16 == 0 && aligned16(x), lane_concat_kernel, grid,
                 block, 0, static_cast<cudaStream_t>(stream),
                 static_cast<const int8_t*>(x), m, c,
                 static_cast<const int8_t*>(w), taps, n,
                 static_cast<int32_t*>(out));
}

// The same arguments as bnn_probe_lane_concat; taps·c <= 48 KB.
int bnn_probe_scratch_lane_store(const void* x, int m, int c, const void* w,
                                 int taps, int n, void* out, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  const int kc = taps * c;
  if (kc <= 0 || kc > kScratchSmem) return cudaErrorInvalidValue;
  const int fit = kScratchSmem / kc;
  const int tile_rows = fit < kScratchRows ? fit : kScratchRows;
  const int blocks = (m + tile_rows - 1) / tile_rows;
  const size_t smem = static_cast<size_t>(tile_rows) * kc;
  BNN_LAUNCH_VEC(c % 16 == 0 && aligned16(x), scratch_lane_store_kernel,
                 blocks, kThreads, smem, static_cast<cudaStream_t>(stream),
                 static_cast<const int8_t*>(x), m, c,
                 static_cast<const int8_t*>(w), taps, n, tile_rows,
                 static_cast<int32_t*>(out));
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
