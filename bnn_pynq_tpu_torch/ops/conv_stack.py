"""Quantized conv chains and thresholded dense blocks.

Ports of `bnn_pynq_tpu/ops/conv_stack.py`:
- `conv_chain` ← `conv_chain_vmem`: chained VALID K×K convs, each an exact
  int dot + MultiThreshold to codes, on activation codes, on a raw int8
  image (`input_levels=True`), or on prebuilt first-layer patches
  (`input_patches=True`, e.g. `sliding_window` with a stride). Unlike the
  JAX kernel it returns the valid region only, or (`pool=True`) the 2×2
  max-pool of it, which the last layer's epilogue computes. CUDA kernel:
  `csrc/conv_chain.cu` (entry `bnn_conv_layer`), launched once per layer
  (the intermediate codes go through device memory); prebuilt patches are
  its layer 0 at kernel 1.
- `conv_chain_vmem`: JAX's name and signature over `conv_chain`, returning
  JAX's full-grid shape (the valid region, zero beyond it).
- `dense_block` ← `dense_block`: chained dense layers, all thresholded,
  codes (or levels) in, codes out. CUDA kernel: `csrc/dense_block.cu`
  (entry `bnn_dense_block`), launched once per layer likewise.
- `dense_residual` (no JAX counterpart: ResNet-50's block-closing 1×1
  conv): one thresholded dense layer whose accumulator takes a bottleneck
  block's shortcut before the thresholds, MT(c + r ⊙ p). The same kernel
  (entry `bnn_dense_residual`): the identity's codes added in the
  epilogue, or the projection's product in the K loop.

Codes are bipolar (level 2c − off), 4-bit codes their own levels; a
first layer's input is levels with `input_levels` (the image, or
ResNet's unsigned 2-bit codes), and `dense_residual` takes unsigned codes.

Both kernels run their dots on the int8 tensor cores (`csrc/mma_tile.cuh`)
and read the weights' `nk32` layout and `wsum` (models/params.py). A CPU
tensor runs the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bnn_pynq_tpu_torch.ops import _build
from bnn_pynq_tpu_torch.ops.conv import maxpool2d, sliding_window
from bnn_pynq_tpu_torch.ops.fused_mlp import (check_chain,
                                              check_cuda_operands)
from bnn_pynq_tpu_torch.ops.ref import int_matmul_ref
from bnn_pynq_tpu_torch.ops.thresholds import (codes_are_levels,
                                               codes_to_values,
                                               count_search, multithreshold,
                                               pooled_epilogue,
                                               residual_epilogue)


def conv_chain_plain(x, weights, thresholds, *, kernel: int, abits: int,
                     input_patches: bool = False, input_levels: bool = False,
                     pool: bool = False) -> torch.Tensor:
    """Plain PyTorch version of `conv_chain` (same arguments; `pool` is
    `maxpool2d` of the chain's codes, whose map `conv_chain` has checked
    to be even)."""
    act = x
    for j, (w, thr) in enumerate(zip(weights, thresholds)):
        vals = act if (j == 0 and input_levels) else \
            codes_to_values(act, abits)
        patches = vals if (j == 0 and input_patches) else \
            sliding_window(vals, kernel, kernel, 1)
        b, oh, ow, k = patches.shape
        acc = int_matmul_ref(patches.reshape(b * oh * ow, k), w.kn)
        act = multithreshold(acc, thr).reshape(b, oh, ow, w.kn.shape[1])
    return maxpool2d(act) if pool else act


def conv_chain(x: torch.Tensor, weights: Sequence,
               thresholds: Sequence[torch.Tensor], *, kernel: int,
               abits: int, input_patches: bool = False,
               input_levels: bool = False, pool: bool = False) -> torch.Tensor:
    """Chained stride-1 VALID K×K convs, every one thresholded (a strided
    first conv comes as its prebuilt patches).

    x: int8 [B, H, W, C0] activation codes, or int8 levels (e.g. the
       centred image) if `input_levels` — which applies to layer 0 only.
       With `input_patches`, x is layer 0's prebuilt patches
       [B, H, W, K²·C_in] in (ki, kj, c) order (`ops/conv.py::
       sliding_window`, which also absorbs a strided first conv): layer 0
       is then the product over the patch lanes at each pixel and keeps
       the grid.
    weights: WeightMatrix per layer, levels [K²C_j, C_{j+1}] in (ki,kj,c)
       order. thresholds: int32 [nthr, C_{j+1}] per layer; a 15-row
       table ascending in each channel on a CUDA tensor (the kernel
       searches it; `models/params.py` sorts them so).
    Returns int8 codes [B, H - n(K-1), W - n(K-1), C_last], n the layers
    that convolve in here (all of them, or all but layer 0 with
    `input_patches`). pool: their 2×2 max-pool instead, [B, OH/2, OW/2,
    C_last], which the last layer's epilogue computes on a CUDA tensor
    (the maximum of each window's accumulators, thresholded: the code
    never falls as the accumulator grows, so it is the largest code); an
    odd OH or OW raises ValueError (`maxpool2d` would drop the edge).

    On a CUDA tensor prebuilt patches run as the kernel's layer at kernel
    1, their lanes zero-padded to the weights' `nk32` width first (the
    weights are zero there, so any pad is safe): whole 32-byte-aligned
    rows that the kernel copies into shared memory, where K²·C_in lanes
    that are no multiple of 32 (27 for a 3-channel image) would take its
    byte-wise patch gather.
    """
    if len(thresholds) != len(weights):
        raise ValueError("one threshold table per chained layer")
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"x must be int8 [B, H, W, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    for j, (wt, thr) in enumerate(zip(weights, thresholds)):
        ks = 1 if (j == 0 and input_patches) else kernel
        if wt.kn.shape[0] != ks * ks * c:
            raise ValueError(f"layer {j}: weight rows {wt.kn.shape[0]} != "
                             f"K²C {ks * ks * c}")
        if thr.dtype != torch.int32 or thr.ndim != 2 or \
                thr.shape[1] != wt.kn.shape[1]:
            raise ValueError(f"layer {j}: thresholds must be int32 "
                             f"[nthr, {wt.kn.shape[1]}]")
        h, w, c = h - ks + 1, w - ks + 1, wt.kn.shape[1]
        if h < 1 or w < 1:
            raise ValueError(f"layer {j}: {kernel}×{kernel} conv leaves no "
                             "valid region")
    if pool and (h % 2 or w % 2):
        raise ValueError(f"pool: the chain's {h}×{w} map is odd; a 2×2 "
                         "pool of it would drop its edge")
    if x.device.type == "cpu":
        return conv_chain_plain(x, weights, thresholds, kernel=kernel,
                                abits=abits, input_patches=input_patches,
                                input_levels=input_levels, pool=pool)
    check_cuda_operands(x, weights, thresholds)
    levels = codes_are_levels(abits)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    act = x
    for j, (wt, thr) in enumerate(zip(weights, thresholds)):
        ks = kernel
        if j == 0 and input_patches:
            ks, k32 = 1, wt.nk32.shape[1]
            if act.shape[-1] != k32:
                act = torch.nn.functional.pad(act, (0, k32 - act.shape[-1]))
        b, h, w, c = act.shape
        n = wt.kn.shape[1]
        pooled = pool and j == len(weights) - 1
        f = 2 if pooled else 1
        out = torch.empty((b, (h - ks + 1) // f, (w - ks + 1) // f, n),
                          dtype=torch.int8, device=x.device)
        lib.call("bnn_conv_layer", act.data_ptr(), b, h, w, c, ks,
                 int((j == 0 and input_levels) or levels), wt.nk32.data_ptr(),
                 wt.nk32.shape[1], n, wt.wsum.data_ptr(), thr.data_ptr(),
                 thr.shape[0], abits, int(pooled), out.data_ptr(), stream)
        conv_chain.launches.add()
        count_search(thr)
        if pooled:
            pooled_epilogue.add()
        act = out
    return act


conv_chain.launches = _build.LaunchCounter()


def conv_chain_vmem(x: torch.Tensor, weights: Sequence,
                    thresholds: Sequence[torch.Tensor], *, kernel: int,
                    abits: int, input_patches: bool = False,
                    input_levels: bool = False) -> torch.Tensor:
    """`conv_chain` in the JAX kernel's form: int8 codes [B, H, W, C_last]
    on the full input grid, whose valid region [:, :H - n(K-1),
    :W - n(K-1)] (n as in `conv_chain`) equals JAX's and whose border,
    garbage in JAX, is zero here. The routes call `conv_chain`, which
    returns the valid region alone.

    JAX's TPU-only arguments are left out: `interpret`, the tile sizes
    `block_b` and `target_rows`, `build_mode` (its two schedules give the
    same bits) and `offset_mode` (its other values are timing diagnostics
    that give wrong results by design)."""
    out = conv_chain(x, weights, thresholds, kernel=kernel, abits=abits,
                     input_patches=input_patches, input_levels=input_levels)
    _, h, w, _ = x.shape
    return torch.nn.functional.pad(
        out, (0, 0, 0, w - out.shape[2], 0, h - out.shape[1]))


def dense_block_plain(x_codes, weights, thresholds, *, abits: int,
                      input_levels: bool = False) -> torch.Tensor:
    """Plain PyTorch version of `dense_block` (same arguments)."""
    act = x_codes if input_levels else codes_to_values(x_codes, abits)
    for j, (w, thr) in enumerate(zip(weights, thresholds)):
        code = multithreshold(int_matmul_ref(act, w.kn), thr)
        if j < len(weights) - 1:
            act = codes_to_values(code, abits)
    return code


def dense_block(x_codes: torch.Tensor, weights: Sequence,
                thresholds: Sequence[torch.Tensor], *, abits: int,
                input_levels: bool = False) -> torch.Tensor:
    """Chained dense layers, all thresholded.

    x_codes: int8 [M, K0] codes (or levels if `input_levels`).
    weights: WeightMatrix per layer [K_i, N_i]; thresholds: int32
    [nthr, N_i] per layer; a 15-row table ascending in each channel on a
    CUDA tensor (the kernel searches it; `models/params.py` sorts them so).
    Returns int8 codes [M, N_last].
    """
    if len(thresholds) != len(weights):
        raise ValueError("one threshold table per layer")
    check_chain(x_codes, weights, thresholds)
    if x_codes.device.type == "cpu":
        return dense_block_plain(x_codes, weights, thresholds, abits=abits,
                                 input_levels=input_levels)
    check_cuda_operands(x_codes, weights, thresholds)
    levels = codes_are_levels(abits)
    lib = _build.library()
    stream = torch.cuda.current_stream(x_codes.device).cuda_stream
    act = x_codes
    for j, (wt, thr) in enumerate(zip(weights, thresholds)):
        m, k = act.shape
        n = wt.kn.shape[1]
        out = torch.empty((m, n), dtype=torch.int8, device=act.device)
        lib.call("bnn_dense_block", act.data_ptr(), m, k,
                 int((j == 0 and input_levels) or levels), wt.nk32.data_ptr(),
                 wt.nk32.shape[1], n, wt.wsum.data_ptr(), thr.data_ptr(),
                 thr.shape[0], abits, out.data_ptr(), stream)
        dense_block.launches.add()
        count_search(thr)
        act = out
    return act


dense_block.launches = _build.LaunchCounter()


def _shortcut_rows(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The block input's codes at the output's pixels, [B·OH·OW, C]."""
    xs = x[:, ::stride, ::stride, :] if stride != 1 else x
    return xs.reshape(-1, x.shape[-1])


def dense_residual_plain(rows, x, w, r, thr, *, stride: int,
                         projection: bool) -> torch.Tensor:
    """Plain PyTorch version of `dense_residual` (same arguments): the
    identity's r ⊙ x added to the product, or the product over
    [rows | x at the stride]."""
    xs = _shortcut_rows(x, stride)
    if projection:
        acc = int_matmul_ref(torch.cat([rows, xs], dim=1), w.kn)
    else:
        acc = int_matmul_ref(rows, w.kn) + r * xs.to(torch.int32)
    return multithreshold(acc, thr)


def dense_residual(rows: torch.Tensor, x: torch.Tensor, w, r: torch.Tensor,
                   thr: torch.Tensor, *, stride: int,
                   projection: bool) -> torch.Tensor:
    """A bottleneck block's last 1×1 conv with its shortcut, thresholded:
    codes MT(rows · W_c + r ⊙ p) [M, N].

    rows: int8 [M, K1] unsigned codes (their own levels) of the block's
      3×3 conv, M = B·OH·OW pixels of its output map.
    x: int8 [B, H, W, C] unsigned codes, the block's input, with
      OH = (H − 1) // stride + 1 (and so OW).
    w: WeightMatrix. Identity (stride 1, C = N): W_c [K1, N], and p = x,
      which the kernel's epilogue adds, r[n]·x[m, n], to each accumulator.
      Projection: [W_c ; W_p·diag(r)] [K1 + C, N] (models/params.py), and
      the kernel's K loop runs over rows, then over x at the stride, so p
      = x_s · W_p enters the same accumulator.
    r: int32 [N], the shortcut's multiplier (the projection's is in w).
    thr: int32 [nthr, N] (1-3 rows).
    No int32 map goes through memory. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel (a `dense_kernel` whose
    residual template argument is 1 for the identity and 2 for the
    projection), which `residual_epilogue` counts."""
    m, k1 = rows.shape
    b, h, wd, c = x.shape
    oh, ow = (h - 1) // stride + 1, (wd - 1) // stride + 1
    n = w.kn.shape[1]
    if rows.dtype != torch.int8 or x.dtype != torch.int8 or \
            m != b * oh * ow:
        raise ValueError(f"rows int8 [{b * oh * ow}, K1] and x int8 "
                         f"[B, H, W, C], got {rows.dtype} "
                         f"{tuple(rows.shape)}, {x.dtype} {tuple(x.shape)}")
    if w.kn.shape[0] != k1 + (c if projection else 0) or \
            (not projection and (c != n or stride != 1)):
        raise ValueError(f"weights [{w.kn.shape[0]}, {n}] for K1 {k1}, C "
                         f"{c}, stride {stride}, projection {projection}")
    if r.dtype != torch.int32 or tuple(r.shape) != (n,) or \
            thr.dtype != torch.int32 or thr.ndim != 2 or thr.shape[1] != n:
        raise ValueError(f"r int32 [{n}] and thresholds int32 [nthr, {n}]")
    if rows.device.type == "cpu":
        return dense_residual_plain(rows, x, w, r, thr, stride=stride,
                                    projection=projection)
    check_cuda_operands(rows, [w], [thr], x, r)
    if thr.shape[0] > 3:
        raise ValueError("dense_residual takes 1-3 thresholds a channel")
    out = torch.empty((m, n), dtype=torch.int8, device=rows.device)
    _build.library().call(
        "bnn_dense_residual", rows.data_ptr(), m, k1, x.data_ptr(), h, wd,
        c, stride, oh, ow, int(projection), r.data_ptr(),
        w.nk32.data_ptr(), w.nk32.shape[1], n, thr.data_ptr(), thr.shape[0],
        out.data_ptr(), torch.cuda.current_stream(rows.device).cuda_stream)
    dense_block.launches.add()
    residual_epilogue.add()
    return out
