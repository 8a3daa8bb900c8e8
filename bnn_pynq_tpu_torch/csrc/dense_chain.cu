// A whole quantized MLP in one kernel: chained dense layers, codes in, float
// logits out.
//
// Replaces bnn_pynq_tpu/ops/fused_mlp.py::fused_mlp_forward (SFC/LFC, and
// CNV's tail with conv6 folded in). Entry point: bnn_fused_mlp.
// (bnn_pynq_tpu/ops/conv_stack.py::dense_block, which shares this body in
// the JAX package, has its own tensor-core kernel here: dense_block.cu,
// entry bnn_dense_block.)
//
// One block owns a tile of kChainRows rows. The tile's activations stay in
// shared memory as int8 levels for the whole chain, ping-ponged between two
// buffers, so only the input codes and the last layer's output touch device
// memory. Each layer is layer_tile (dense_tile.cuh): one thread per output
// column, int32 dots by __dp4a, threshold epilogue.
//
// What bounds it on the H100: the weights do not fit in shared memory
// (LFC ~2.9 MB, CNV tail ~0.94 MB against 227 KB), so every block streams
// them from L2 (the whole set is far below its 50 MB); the dots run on the
// CUDA cores' dp4a, not on the tensor cores. The design keeps activations
// on chip and reuses each 16-byte weight load across kChainRows rows held
// in registers; the activation tile is small (2 × 8 rows × the widest K:
// 36 KB for the CNV tail), which leaves room for several blocks per SM.
// Moving these dots to the int8 mma of mma_tile.cuh, with weight slices
// staged in shared memory, is later work.
#include "dense_tile.cuh"

namespace bnn {
namespace {

constexpr int kMaxLayers = 8;
constexpr int kChainRows = 8;   // rows of a block's tile
constexpr int kChainRpt = 8;    // rows a thread computes per weight load

struct ChainArgs {
  const int8_t* x;              // [m, k0] codes
  int m;
  int k0;
  int n_layers;
  int nthr;
  int level_off;
  int stride;                   // shared-memory row stride, % kVec == 0
  const int8_t* w[kMaxLayers];  // [n[l], kp[l]] levels
  const int32_t* thr[kMaxLayers];
  int kp[kMaxLayers];
  int n[kMaxLayers];
  float* out_logits;            // [m, n_last]
  const float* scale;
  const float* bias;
};

__global__ void __launch_bounds__(kThreads)
dense_chain_kernel(const ChainArgs a) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* buf[2] = {smem, smem + kChainRows * a.stride};
  const int row0 = blockIdx.x * kChainRows;
  const int rows = min(kChainRows, a.m - row0);

  // Input codes → levels. Columns [k0, stride) are left as they are: the
  // weights are zero there.
  for (int r = 0; r < rows; ++r) {
    const int8_t* src = a.x + static_cast<size_t>(row0 + r) * a.k0;
    for (int k = threadIdx.x; k < a.k0; k += blockDim.x) {
      const int8_t v = src[k];
      buf[0][r * a.stride + k] = static_cast<int8_t>(2 * v - a.level_off);
    }
  }
  __syncthreads();

  int cur = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    const bool last = l == a.n_layers - 1;
    TileOut o;
    o.mode = last ? kLogitsToGlobal : kLevelsToShared;
    o.next = buf[cur ^ 1];
    o.next_stride = a.stride;
    o.logits = a.out_logits + static_cast<size_t>(row0) * a.n[l];
    o.scale = a.scale;
    o.bias = a.bias;
    layer_tile<kChainRows, kChainRpt>(buf[cur], a.stride, rows, a.w[l],
                                      a.kp[l], a.n[l], a.thr[l], a.nthr,
                                      a.level_off, o);
    __syncthreads();
    cur ^= 1;
  }
}

// w_ptrs / thr_ptrs: host arrays of n_layers device pointers; kp / n: host
// int arrays of n_layers entries. thr_ptrs[n_layers - 1] is unused.
int launch_chain(const void* x, int m, int k0, const void* w_ptrs,
                 const void* thr_ptrs, const void* kp, const void* n,
                 int n_layers, int nthr, int abits, void* out_logits,
                 const void* scale, const void* bias, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || nthr < 1 || nthr > kMaxThr ||
      (abits != 1 && abits != 2) || m < 0 || k0 < 1 || out_logits == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;
  const void* const* wp = static_cast<const void* const*>(w_ptrs);
  const void* const* tp = static_cast<const void* const*>(thr_ptrs);
  const int* kps = static_cast<const int*>(kp);
  const int* ns = static_cast<const int*>(n);

  ChainArgs a = {};
  a.x = static_cast<const int8_t*>(x);
  a.m = m;
  a.k0 = k0;
  a.n_layers = n_layers;
  a.nthr = nthr;
  a.level_off = abits == 1 ? 1 : 3;
  a.stride = round_up(k0, kVec);
  for (int l = 0; l < n_layers; ++l) {
    const int k_in = l == 0 ? k0 : ns[l - 1];
    if (kps[l] != round_up(k_in, kVec) || ns[l] < 1) {
      return cudaErrorInvalidValue;
    }
    a.w[l] = static_cast<const int8_t*>(wp[l]);
    a.thr[l] = static_cast<const int32_t*>(tp[l]);
    a.kp[l] = kps[l];
    a.n[l] = ns[l];
    a.stride = a.stride > kps[l] ? a.stride : kps[l];
  }
  a.out_logits = static_cast<float*>(out_logits);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);

  const size_t smem = 2 * static_cast<size_t>(kChainRows) * a.stride;
  cudaError_t err = allow_smem(dense_chain_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (m + kChainRows - 1) / kChainRows;
  dense_chain_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bnn

extern "C" {

// fused_mlp: x codes [m, k0] → float32 logits [m, n_last]; every layer but
// the last is thresholded, the last applies scale/bias.
int bnn_fused_mlp(const void* x, int m, int k0, const void* w_ptrs,
                  const void* thr_ptrs, const void* kp, const void* n,
                  int n_layers, int nthr, int abits, const void* scale,
                  const void* bias, void* out, void* stream) {
  return bnn::launch_chain(x, m, k0, w_ptrs, thr_ptrs, kp, n, n_layers, nthr,
                           abits, out, scale, bias, stream);
}

const char* bnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
