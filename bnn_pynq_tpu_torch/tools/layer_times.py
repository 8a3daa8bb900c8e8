"""Where the `mega`, `direct`, `vpu`, `xla` and `xlaconv` routes' device
time goes on a CUDA card.

    python -m bnn_pynq_tpu_torch.tools.layer_times [--only SECTION ...]

Needs one CUDA card and nvcc. Without options it prints all five sections
(`layers`, `packed`, `rates`, `profiles`, `probes`), at batch 1024:

1. for CNV-W1A1's four `conv_chain` layers (conv1 and conv3 with the 2×2
   pool in their epilogue, as the `mega` route runs them) and its
   `dense_block` (block6) on seeded inputs and random weights: the device
   ms per call under CUDA graph replay (`graph_ms`: 10 calls a graph,
   median of 20 replays; no host enqueue in the reading), the int8
   operations per call, the rate reached; the same for the five
   `conv2d_direct` layers of the `direct` route (the last, whose kernel
   covers its map, also through the conv kernel and through
   `dense_block`'s on the flattened rows), and for `fused_mlp` at the
   widths of CNV's tail, LFC and SFC, at 1024 rows and at one;
2. `packed`: `packed_matmul` at the eight packed layers of CNV-W1A1 on the
   popcount arm ('vpu') and on the decode arm ('mxu'), at one row (batch-1
   dense layers) and at the 10-column last layer, and `conv_chain_direct`
   at CNV's two chains, all under graph replay, with the rate reached;
3. `rates`: the rate of a loop of `mma.sync.aligned.m16n8k32.s8` alone (no
   memory, 16 independent accumulators a warp, 8 and 16 warps an SM) and of
   the same loop fed by `ldmatrix` at the kernels' ratio of 6 loads per 16
   mma: what this instruction reaches on the card, below the published
   tensor-core peak that `wgmma` is needed for; then the same two loops for
   the 1-bit `mma.sync.aligned.m16n8k256.b1` with `.and.popc` and with
   `.xor.popc` (each built on its own: a form the assembler refuses for this
   card is reported, not fatal), each after a one-warp check of the
   fragment layout the packed kernel relies on against a popcount on the
   host;
4. `profiles`: one forward of the pretrained CNV-W1A1 engine on a
   device-resident batch on the `mega`, `direct` and `vpu` routes and the
   decoded-integer `xla` and `xlaconv` (and CNV-W2A2 on `direct`): its
   device ms under graph replay, the host ms to enqueue it (the engine's
   captured program, and the eager forward) and to prepare its 1024
   images, and from one `torch.profiler` trace of 20
   eager forwards the device ms per forward of every kernel in it, by
   name;
5. `probes`: where the two dot probes' time goes (`csrc/mosaic_probes.cu`,
   `shifted_dot_kernel`, at JAX's shape): a copy of the source whose kernel
   returns after a phase chosen at run time (at entry, after staging the A
   tile and the weights, after the k32 steps), built on its own, each cut
   timed under graph replay beside the whole kernel and the launch floor
   (one one-element `torch.add_`).

The last line names the card and its power limit as `nvidia-smi` gives them.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from bnn_pynq_tpu_torch.models.params import weight_matrix
from bnn_pynq_tpu_torch.ops import (_build, conv_direct, conv_stack,
                                    fused_mlp, matmul)
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.utils.profiling import graph_stats

BATCH = 1024
# (label, input H = W, C, N): the chain layers of CNV (3×3, stride 1)
CONV_LAYERS = (("conv0", 32, 3, 64), ("conv1", 30, 64, 64),
               ("conv2", 14, 64, 128), ("conv3", 12, 128, 128))
# the chain layers a 2×2 pool follows, pooled in their epilogue on `mega`
POOLED = ("conv1", "conv3")
BLOCK6 = (9, 1152, 256)        # rows per image, K, N
# the direct route's conv layers (3×3, stride 1): conv1-3 above, then
DIRECT_LAYERS = CONV_LAYERS[1:] + (("conv4", 5, 128, 256),
                                   ("conv5", 3, 256, 256))
# (label, layer widths) of the whole-MLP kernel's main-path shapes
MLPS = (("cnv tail", (2304, 256, 512, 512, 10)),
        ("lfc", (784, 1024, 1024, 1024, 10)),
        ("sfc", (784, 256, 256, 256, 10)))
# (label, M at batch 1024, K, N) of CNV-W1A1's packed layers; the last has no
# thresholds (int32 out)
PACKED_LAYERS = (("conv1", 802816, 576, 64), ("conv2", 147456, 576, 128),
                 ("conv3", 102400, 1152, 128), ("conv4", 9216, 1152, 256),
                 ("conv5", 1024, 2304, 256), ("dense0", 1024, 256, 512),
                 ("dense1", 1024, 512, 512), ("dense2", 1024, 512, 10))
PRETRAINED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "pretrained")

RATE_SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldm(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// LOADS 0: mma only. LOADS 1: 6 ldmatrix.x4 + 16 mma a step (rows of 80
// bytes: no bank conflicts).
template <int LOADS>
__global__ void __launch_bounds__(256, 2) rate_kernel(int iters, int* out) {
  extern __shared__ __align__(16) int8_t sm[];
  for (int i = threadIdx.x; i < 32768; i += 256) sm[i] = (int8_t)i;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned base =
      (unsigned)__cvta_generic_to_shared(sm) + (threadIdx.x >> 5) * 2048;
  const unsigned addr =
      base + ((lane & 7) + ((lane >> 3) & 1) * 8) * 80 + (lane >> 4) * 16;
  int c[2][8][4] = {};
  unsigned a[2][4] = {{1u * lane, 2, 3, 4}, {5, 6, 7, 8}};
  unsigned b[4][4] = {{1, 2, 3, 4}, {5, 6, 7, 8}, {9, 1, 2, 3}, {4, 5, 6, 7}};
  for (int it = 0; it < iters; ++it) {
    if (LOADS) {
      ldm(a[0], addr + (it & 1) * 32);
      ldm(a[1], addr + 16 * 80 + (it & 1) * 32);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (LOADS) ldm(b[jp], addr + 4096 + jp * 1280 + (it & 1) * 32);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        mma_s8(c[mb][2 * jp], a[mb], b[jp][0], b[jp][1]);
        mma_s8(c[mb][2 * jp + 1], a[mb], b[jp][2], b[jp][3]);
      }
    }
  }
  int s = 0;
  for (int mb = 0; mb < 2; ++mb)
    for (int j = 0; j < 8; ++j)
      for (int e = 0; e < 4; ++e) s += c[mb][j][e];
  if (s == 123456789) out[0] = s;
}
template <int LOADS>
void run(int sms, int blocks_per_sm, const char* name) {
  int* out;
  cudaMalloc(&out, 4);
  const int iters = 20000, grid = sms * blocks_per_sm;
  cudaFuncSetAttribute(rate_kernel<LOADS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, 100000);
  const size_t smem = blocks_per_sm == 1 ? 100000 : 40000;
  rate_kernel<LOADS><<<grid, 256, smem>>>(100, out);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate_kernel<LOADS><<<grid, 256, smem>>>(iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double ops = 2.0 * 16 * 8 * 32 * 16 * (double)iters * 8 * grid;
  printf("mma.sync m16n8k32 s8, %s, %d warps an SM: %.3f ms, %.1f TOP/s (%s)\n",
         name, 8 * blocks_per_sm, ms, ops / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  run<0>(sms, 1, "registers only");
  run<0>(sms, 2, "registers only");
  run<1>(sms, 1, "6 ldmatrix.x4 per 16 mma");
  run<1>(sms, 2, "6 ldmatrix.x4 per 16 mma");
  return 0;
}
"""

# The 1-bit mma: -DB1_OP=and|xor -DB1_XOR=0|1. First one warp checks the
# fragment layout (A: registers a0..a3 = words t, t (row g + 8), 4 + t,
# 4 + t (row g + 8) of a row's 8-word step; B: b0, b1 = words t, 4 + t of
# column g; C: c0, c1 = [g][2t], [g][2t + 1], c2, c3 the same of row g + 8)
# against a popcount on the host, then the rate loops of RATE_SOURCE.
B1_SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>
#define STR2(x) #x
#define STR(x) STR2(x)
__device__ __forceinline__ void mma_b1(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32." STR(B1_OP) ".popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldm(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__global__ void layout_kernel(const unsigned* A, const unsigned* B, int* C) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const unsigned a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + 4 + t],
                         A[(g + 8) * 8 + 4 + t]};
  int c[4] = {0, 0, 0, 0};
  mma_b1(c, a, B[g * 8 + t], B[g * 8 + 4 + t]);
  C[g * 8 + 2 * t] = c[0];
  C[g * 8 + 2 * t + 1] = c[1];
  C[(g + 8) * 8 + 2 * t] = c[2];
  C[(g + 8) * 8 + 2 * t + 1] = c[3];
}
template <int LOADS>
__global__ void __launch_bounds__(256, 2) rate_kernel(int iters, int* out) {
  extern __shared__ __align__(16) int8_t sm[];
  for (int i = threadIdx.x; i < 32768; i += 256) sm[i] = (int8_t)i;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned base =
      (unsigned)__cvta_generic_to_shared(sm) + (threadIdx.x >> 5) * 2048;
  const unsigned addr =
      base + ((lane & 7) + ((lane >> 3) & 1) * 8) * 80 + (lane >> 4) * 16;
  int c[2][8][4] = {};
  unsigned a[2][4] = {{1u * lane, 2, 3, 4}, {5, 6, 7, 8}};
  unsigned b[4][4] = {{1, 2, 3, 4}, {5, 6, 7, 8}, {9, 1, 2, 3}, {4, 5, 6, 7}};
  for (int it = 0; it < iters; ++it) {
    if (LOADS) {
      ldm(a[0], addr + (it & 1) * 32);
      ldm(a[1], addr + 16 * 80 + (it & 1) * 32);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (LOADS) ldm(b[jp], addr + 4096 + jp * 1280 + (it & 1) * 32);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        mma_b1(c[mb][2 * jp], a[mb], b[jp][0], b[jp][1]);
        mma_b1(c[mb][2 * jp + 1], a[mb], b[jp][2], b[jp][3]);
      }
    }
  }
  int s = 0;
  for (int mb = 0; mb < 2; ++mb)
    for (int j = 0; j < 8; ++j)
      for (int e = 0; e < 4; ++e) s += c[mb][j][e];
  if (s == 123456789) out[0] = s;
}
template <int LOADS>
void run(int sms, int blocks_per_sm, const char* name) {
  int* out;
  cudaMalloc(&out, 4);
  const int iters = 20000, grid = sms * blocks_per_sm;
  cudaFuncSetAttribute(rate_kernel<LOADS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, 100000);
  const size_t smem = blocks_per_sm == 1 ? 100000 : 40000;
  rate_kernel<LOADS><<<grid, 256, smem>>>(100, out);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate_kernel<LOADS><<<grid, 256, smem>>>(iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double ops = 2.0 * 16 * 8 * 256 * 16 * (double)iters * 8 * grid;
  printf("mma.sync m16n8k256 b1 " STR(B1_OP) ".popc, %s, %d warps an SM: "
         "%.3f ms, %.1f TOP/s binary (%s)\n",
         name, 8 * blocks_per_sm, ms, ops / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main() {
  unsigned hA[128], hB[64], *dA, *dB;
  int hC[128], *dC;
  srand(7);
  for (int i = 0; i < 128; ++i) hA[i] = (unsigned)rand() * 2654435761u;
  for (int i = 0; i < 64; ++i) hB[i] = (unsigned)rand() * 2246822519u;
  cudaMalloc(&dA, sizeof hA);
  cudaMalloc(&dB, sizeof hB);
  cudaMalloc(&dC, sizeof hC);
  cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout_kernel<<<1, 32>>>(dA, dB, dC);
  cudaMemcpy(hC, dC, sizeof hC, cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int r = 0; r < 16; ++r)
    for (int n = 0; n < 8; ++n) {
      int want = 0;
      for (int w = 0; w < 8; ++w) {
        const unsigned x = B1_XOR ? hA[r * 8 + w] ^ hB[n * 8 + w]
                                  : hA[r * 8 + w] & hB[n * 8 + w];
        want += __builtin_popcount(x);
      }
      bad += want != hC[r * 8 + n];
    }
  printf("mma.sync m16n8k256 b1 " STR(B1_OP) ".popc, one warp against the "
         "host's popcount: %s (%d of 128 differ; %s)\n",
         bad ? "MISMATCH" : "equal", bad,
         cudaGetErrorString(cudaGetLastError()));
  if (bad) return 1;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  run<0>(sms, 1, "registers only");
  run<0>(sms, 2, "registers only");
  run<1>(sms, 1, "6 ldmatrix.x4 per 16 mma");
  run<1>(sms, 2, "6 ldmatrix.x4 per 16 mma");
  return 0;
}
"""


def graph_ms(fn, calls: int = 10, reps: int = 20) -> float:
    """Device ms per call under CUDA graph replay (median of `reps`
    replays of `calls` captured calls; `utils/profiling.py::graph_stats`)."""
    return graph_stats(fn, calls, reps)[0]


def layer_times(device: torch.device) -> None:
    rng = np.random.default_rng(0)

    def dev(a):
        return torch.from_numpy(a).to(device)

    def layer(k, n):
        w = weight_matrix(dev(rng.choice([-1, 1], size=(k, n))
                              .astype(np.int8)))
        sd = int(k ** .5)
        thr = dev(rng.integers(-sd, sd + 1, size=(1, n)).astype(np.int32))
        return w, thr

    total = 0.0
    for label, hw, c, n in CONV_LAYERS:
        image = c == 3
        x = rng.integers(-128, 128, size=(BATCH, hw, hw, c)) if image \
            else rng.integers(0, 2, size=(BATCH, hw, hw, c))
        x = dev(x.astype(np.int8))
        w, thr = layer(9 * c, n)
        pool = label in POOLED
        ms = graph_ms(lambda: conv_stack.conv_chain(
            x, [w], [thr], kernel=3, abits=1, input_levels=image, pool=pool))
        ops = 2 * BATCH * (hw - 2) ** 2 * 9 * c * n
        total += ms
        print(f"{label}{' pooled' * pool} {tuple(x.shape)} -> {n}: "
              f"{ms:.4f} ms, "
              f"{ops / 1e9:.1f} G operations, {ops / ms / 1e9:.1f} TOP/s")
    print(f"conv_chain, the four layers: {total:.4f} ms")
    rows, k, n = BLOCK6
    x = dev(rng.integers(0, 2, size=(BATCH * rows, k)).astype(np.int8))
    w, thr = layer(k, n)
    ms = graph_ms(lambda: conv_stack.dense_block(x, [w], [thr], abits=1))
    ops = 2 * BATCH * rows * k * n
    print(f"block6 {tuple(x.shape)} -> {n}: {ms:.4f} ms, "
          f"{ops / 1e9:.1f} G operations, {ops / ms / 1e9:.1f} TOP/s")

    total = 0.0
    for label, hw, c, n in DIRECT_LAYERS:
        x = dev(rng.integers(0, 2, size=(BATCH, hw, hw, c)).astype(np.int8))
        w, thr = layer(9 * c, n)
        ms = graph_ms(lambda: conv_direct.conv2d_direct(
            x, w, thr, kernel=3, abits=1))
        ops = 2 * BATCH * (hw - 2) ** 2 * 9 * c * n
        total += ms
        print(f"direct {label} {tuple(x.shape)} -> {n}: {ms:.4f} ms, "
              f"{ops / 1e9:.1f} G operations, {ops / ms / 1e9:.1f} TOP/s")
        if hw == 3:     # the kernel covers the map: a dense layer on rows
            conv_ms = graph_ms(lambda: conv_stack.conv_chain(
                x, [w], [thr], kernel=3, abits=1))
            rows = x.reshape(BATCH, 9 * c)
            ring_ms = graph_ms(lambda: conv_stack.dense_block(
                rows, [w], [thr], abits=1))
            print(f"  the same layer through the conv kernel {conv_ms:.4f} "
                  f"ms, through dense_block's kernel {ring_ms:.4f} ms")
    print(f"conv2d_direct, the five layers: {total:.4f} ms")

    for label, widths in MLPS:
        ws, ts = zip(*(layer(k, n) for k, n in zip(widths, widths[1:])))
        scale = dev(rng.uniform(0.01, 1.0, size=widths[-1])
                    .astype(np.float32))
        bias = dev(rng.standard_normal(widths[-1]).astype(np.float32))
        ops = 2 * BATCH * sum(k * n for k, n in zip(widths, widths[1:]))
        x = dev(rng.integers(0, 2, size=(BATCH, widths[0])).astype(np.int8))
        ms, ms1 = (graph_ms(lambda: fused_mlp.fused_mlp_forward(
            xs, ws, ts[:-1], scale, bias, abits=1)) for xs in (x, x[:1]))
        print(f"fused_mlp {label} {'-'.join(map(str, widths))}: {ms:.4f} ms "
              f"at {BATCH} rows ({ops / 1e9:.2f} G operations, "
              f"{ops / ms / 1e9:.1f} TOP/s), {ms1:.4f} ms at 1 row")


def packed_times(device: torch.device) -> None:
    """`packed_matmul`'s two arms and `conv_chain_direct` under graph replay,
    on seeded random operands."""
    gen = torch.Generator(device=device).manual_seed(0)
    rng = np.random.default_rng(0)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             device=device, dtype=torch.int32)

    def packed(label, m, k, n, routes=("vpu", "mxu")):
        a, w = words(m, k // 32), words(k // 32, n)
        sd = int(k ** .5)
        thr = None if n == 10 else torch.randint(
            -sd, sd + 1, (1, n), generator=gen, device=device,
            dtype=torch.int32)
        out = []
        for route in routes:
            ms = graph_ms(lambda: matmul.packed_matmul(
                a, w, thr, k=k, bits=1, route=route))
            out.append(ms)
            print(f"packed_matmul {route} {label} M={m} K={k} N={n}: "
                  f"{ms:.4f} ms, {2 * m * k * n / ms / 1e9:.1f} TOP/s")
        return out

    totals = np.sum([packed(*layer) for layer in PACKED_LAYERS], axis=0)
    print(f"packed_matmul, the eight layers: vpu {totals[0]:.4f} ms, mxu "
          f"{totals[1]:.4f} ms")
    for label, m, k, n in (("batch-1 dense", 1, 512, 512),
                           ("batch-1 conv5", 1, 2304, 256),
                           ("batch-1 last layer", 1, 512, 10)):
        packed(label, m, k, n)

    def layer(k, n):
        w = weight_matrix(torch.from_numpy(
            rng.choice([-1, 1], size=(k, n)).astype(np.int8)).to(device))
        sd = int(k ** .5)
        return w, torch.from_numpy(rng.integers(
            -sd, sd + 1, size=(1, n)).astype(np.int32)).to(device)

    total = 0.0
    for label, hw, chans, image in (("chain0-1", 32, (3, 64, 64), True),
                                    ("chain2-3", 14, (64, 128, 128), False)):
        x = rng.integers(-128, 128, size=(BATCH, hw, hw, chans[0])) if image \
            else rng.integers(0, 2, size=(BATCH, hw, hw, chans[0]))
        x = torch.from_numpy(x.astype(np.int8)).to(device)
        ws, ts = zip(*(layer(9 * ci, co)
                       for ci, co in zip(chans[:-1], chans[1:])))
        ms = graph_ms(lambda: conv_direct.conv_chain_direct(
            x, list(ws), list(ts), kernel=3, abits=1, input_levels=image))
        cms = graph_ms(lambda: conv_stack.conv_chain(
            x, list(ws), list(ts), kernel=3, abits=1, input_levels=image))
        ops = sum(2 * BATCH * (hw - 2 * (j + 1)) ** 2 * 9 * ci * co
                  for j, (ci, co) in enumerate(zip(chans[:-1], chans[1:])))
        total += ms
        print(f"conv_chain_direct {label} {tuple(x.shape)} -> "
              f"{chans[1:]}: {ms:.4f} ms, {ops / ms / 1e9:.1f} TOP/s; "
              f"conv_chain on the same layers {cms:.4f} ms")
    print(f"conv_chain_direct, the two chains: {total:.4f} ms")


def _build_and_run(tmp: str, name: str, source: str, *defines: str) -> str:
    src, exe = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, name)
    with open(src, "w") as f:
        f.write(source)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-O3", "-std=c++17",
                    *defines, "-o", exe, src], check=True,
                   capture_output=True, text=True)
    return subprocess.run([exe], check=True, capture_output=True,
                          text=True).stdout


def mma_rate() -> None:
    """Build and run the mma.sync rate loops (nvcc into a temporary
    directory, removed afterwards): int8, then the two 1-bit forms."""
    with tempfile.TemporaryDirectory() as tmp:
        print(_build_and_run(tmp, "rate", RATE_SOURCE), end="")
        for op, is_xor in (("and", 0), ("xor", 1)):
            try:
                print(_build_and_run(tmp, f"b1_{op}", B1_SOURCE,
                                     f"-DB1_OP={op}", f"-DB1_XOR={is_xor}"),
                      end="")
            except subprocess.CalledProcessError as e:
                lines = [l for l in (e.stderr or "").splitlines() +
                         (e.stdout or "").splitlines() if l.strip()]
                print(f"mma.sync m16n8k256 b1 {op}.popc: not usable on this "
                      f"card (exit {e.returncode}): "
                      f"{' | '.join(lines[:3]) or 'no output'}")


def forward_profile(device: torch.device, name: str, route: str,
                    forwards: int = 20) -> None:
    """One forward of a pretrained net on a route (device-resident batch in,
    class indices on the device out): graph-replay ms of the eager
    forward, the host's enqueue of the engine's captured program and of
    the eager forward, and the device ms per forward of each kernel in a
    `torch.profiler` trace of the eager forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = InferenceEngine.from_artifact(
        os.path.join(PRETRAINED, f"{name}.npz"), device=device, route=route)
    images = np.random.default_rng(1).integers(
        0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        prepared = eng.prepare(images)
        host.append((time.perf_counter() - t0) * 1e3)
    xd = eng.upload(prepared)

    def forward():
        return eng.launch_prepared(xd, argmax=True)

    def eager():
        return eng._eager(eng._state.params, xd, True, False)

    replay = graph_ms(eager)
    enqueue = {}
    for label, fn in (("program", forward), ("eager", eager)):
        fn()
        times = []
        for _ in range(forwards):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        enqueue[label] = float(np.median(times))
    torch.cuda.synchronize()
    print(f"{route} forward, {name}, batch {BATCH}: {replay:.4f} ms on the "
          f"device under graph replay; host: enqueue of the captured "
          f"program {enqueue['program']:.4f} ms, of the eager forward "
          f"{enqueue['eager']:.4f} ms, prepare {np.median(host):.3f} ms "
          f"(medians of {forwards} and 5, host clock)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            eager()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    count = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / forwards
            count[e.name] += 1
    if not by_name:
        raise RuntimeError("the profiler's trace holds no device event")
    print(f"profile of {forwards} forwards, device ms per forward "
          f"(launches per forward), by kernel:")
    for name, ms in by_name.most_common():
        print(f"  {ms:.4f} ({count[name] / forwards:g}) {name[:100]}")
    print(f"  {sum(by_name.values()):.4f} all kernels")


# shifted_dot_kernel cut short: (the source line it follows, the cut);
# phase 3 keeps the accumulators alive so the k32 steps are not dropped
PHASE_CUTS = (
    ("  const unsigned bar = smem_addr(smem + p.bar_off);\n",
     "  if (bnn_phase == 1) return;\n"),
    ("    stage_weights_t<true>(p, w_s, raw, nc0);\n"
     "    __syncthreads();\n  }\n",
     "  if (bnn_phase == 2) return;\n"),
    ("    item_mma(acc, a_addr, b_addr, end - s, cols);\n    s = end;\n  }\n",
     "  if (bnn_phase == 3) {\n    int keep = 0;\n#pragma unroll\n"
     "    for (int i = 0; i < 64; ++i) keep += (&acc.c[0][0][0])[i];\n"
     "    if (keep == 0x7fffffff) p.out[0] = keep;\n    return;\n  }\n"),
)
PHASES = ("entry", "staged", "k32 steps")


def phase_source(source: str) -> str:
    """csrc/mosaic_probes.cu with shifted_dot_kernel cut after the phase in
    `bnn_phase` (0: whole), set by the exported `bnn_set_phase`."""
    head = source.index("shifted_dot_kernel(const DotArgs p) {")
    body = source[head:]
    for anchor, cut in PHASE_CUTS:
        if body.count(anchor) != 1:
            raise ValueError(f"shifted_dot_kernel has no single {anchor!r}")
        body = body.replace(anchor, anchor + cut)
    return ("__device__ int bnn_phase;\n" + source[:head] + body +
            '\nextern "C" int bnn_set_phase(int phase) {\n'
            "  return cudaMemcpyToSymbol(bnn_phase, &phase, sizeof(int));\n"
            "}\n")


def probe_phases(device: torch.device) -> None:
    """Build the cut copy of the probes' source and time the two dots at
    JAX's shape, phase by phase."""
    import ctypes
    source = (_build.CSRC_DIR / "mosaic_probes.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe_phases.cu")
        lib_path = os.path.join(tmp, "libprobe_phases.so")
        with open(src, "w") as f:
            f.write(phase_source(source))
        subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-shared",
                        "-I", str(_build.CSRC_DIR), "-o", lib_path, src],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(lib_path)
    x = torch.ones((1024 + 128, 64), dtype=torch.int8, device=device)
    w = torch.ones((9 * 64, 64), dtype=torch.int8, device=device)
    out = torch.empty((1024, 64), dtype=torch.int32, device=device)
    one = torch.zeros(1, dtype=torch.int32, device=device)
    print(f"probes: launch floor (one-element add_) "
          f"{graph_ms(lambda: one.add_(1)):.5f} ms, graph replay")
    for name in ("bnn_probe_lane_concat", "bnn_probe_scratch_lane_store"):
        entry = getattr(lib, name)
        entry.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p]

        def call():
            rc = entry(x.data_ptr(), 1024, 64, w.data_ptr(), 9, 64,
                       out.data_ptr(),
                       torch.cuda.current_stream(device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        cuts = []
        for phase in (1, 2, 3, 0):
            if lib.bnn_set_phase(phase) != 0:
                raise RuntimeError("bnn_set_phase failed")
            cuts.append(graph_ms(call))
        shares = [cuts[0]] + [b - a for a, b in zip(cuts, cuts[1:])]
        print(f"  {name[10:]} 1024x576x64: whole {cuts[-1]:.5f} ms; up to "
              + ", ".join(f"{p} {c:.5f}" for p, c in zip(PHASES, cuts))
              + "; each phase " + ", ".join(
                  f"{p} {d:.5f}" for p, d in
                  zip(PHASES + ("epilogue",), shares)))


SECTIONS = ("layers", "packed", "rates", "profiles", "probes")


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("layer_times measures on a CUDA card; none is "
                           "available")
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", nargs="+", choices=SECTIONS,
                        default=SECTIONS, help="the sections to run")
    only = parser.parse_args(argv).only
    device = torch.device("cuda", 0)
    if "layers" in only:
        layer_times(device)
    if "packed" in only:
        packed_times(device)
    if "rates" in only:
        mma_rate()
    for name, route in (("cnv-w1a1", "mega"), ("cnv-w1a1", "direct"),
                        ("cnv-w2a2", "direct"), ("cnv-w1a1", "vpu"),
                        ("cnv-w1a1", "xla"), ("cnv-w1a1", "xlaconv")):
        if "profiles" in only:
            forward_profile(device, name, route)
    if "probes" in only:
        probe_phases(device)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
