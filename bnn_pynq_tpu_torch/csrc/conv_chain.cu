// One stride-1 VALID K×K quantized conv with the MultiThreshold fused:
// NHWC int8 codes (or raw int8 levels) in, int8 codes of the valid region
// [B, H-K+1, W-K+1, N] out, or their 2×2 max-pool. The wrapper
// (ops/conv_stack.py::conv_chain) launches it once per layer of a chain;
// the intermediate codes go through device memory.
//
// The kernel body and its launcher are conv_tile.cuh's, shared with
// conv_direct.cu::bnn_conv_direct; this file holds the entry point.
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
//   the activations are staged in column chunks: on the grid's second axis
//   where the tiles are few, else one pass over the tiles per chunk;
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
// - a layer that a 2×2 max-pool follows (CNV's conv1 and conv4, which
//   models/network.py::forward_mega runs pooled) pools in its epilogue
//   (kConvPool): a tile is then a run of consecutive pooled pixels of the
//   flattened [B·OH/2·OW/2] grid, its row 4q + s the window position s of
//   pooled pixel q, so the input rows it needs (two output rows a pooled
//   row, plus the halo) stay one contiguous span and only the per-pixel
//   offsets into it change; the window's four rows sit in lanes 4 and 8
//   apart, and two shuffles leave each window's largest int32 accumulator
//   in one lane of four, which thresholds it (the code never falls as the
//   accumulator grows, so that is the largest code, exactly) and stores it:
//   a quarter of the compares and of the bytes written, and the separate
//   pool pass gone. An odd map is refused;
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
#include "conv_tile.cuh"

extern "C" {

// x: int8 [b, h, w, c] codes (levels if input_levels); wt: int8 [n_out, k32]
// with k32 = round_up(ksize²·c, 32), zero past K; wsum: int32 [n_out], the
// column sums of wt; thr: int32 [nthr, n_out];
// out: int8 [b, h-ksize+1, w-ksize+1, n_out], or with pool the 2×2
// max-pool of it, [b, (h-ksize+1)/2, (w-ksize+1)/2, n_out] (both even).
int bnn_conv_layer(const void* x, int b, int h, int w, int c, int ksize,
                   int input_levels, const void* wt, int k32, int n_out,
                   const void* wsum, const void* thr, int nthr, int abits,
                   int pool, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool) {
    return bnn::launch_conv<bnn::kConvPool>(x, b, h, w, c, ksize,
                                            input_levels, wt, k32, n_out,
                                            wsum, thr, nthr, abits, out, s);
  }
  return bnn::launch_conv<bnn::kConvCodes>(x, b, h, w, c, ksize,
                                           input_levels, wt, k32, n_out,
                                           wsum, thr, nthr, abits, out, s);
}

}  // extern "C"
