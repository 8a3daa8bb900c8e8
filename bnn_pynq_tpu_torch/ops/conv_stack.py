"""Quantized conv chains and thresholded dense blocks.

Ports of `bnn_pynq_tpu/ops/conv_stack.py`:
- `conv_chain` ← `conv_chain_vmem`: chained stride-1 VALID K×K convs, each
  an exact int dot + MultiThreshold to codes. Unlike the JAX kernel it
  returns the valid region only, and takes a raw int8 image
  (`input_levels=True`) without prebuilt patches. CUDA kernel:
  `csrc/conv_chain.cu` (entry `bnn_conv_layer`), launched once per layer
  (the intermediate codes go through device memory).
- `dense_block` ← `dense_block`: chained dense layers, all thresholded,
  codes (or levels) in, codes out. CUDA kernel: `csrc/dense_block.cu`
  (entry `bnn_dense_block`), launched once per layer likewise.

Both kernels run their dots on the int8 tensor cores (`csrc/mma_tile.cuh`)
and read the weights' `nk32` layout and `wsum` (models/params.py). A CPU
tensor runs the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bnn_pynq_tpu_torch.ops import _build
from bnn_pynq_tpu_torch.ops.conv import sliding_window
from bnn_pynq_tpu_torch.ops.fused_mlp import (check_chain,
                                              check_cuda_operands)
from bnn_pynq_tpu_torch.ops.ref import int_matmul_ref
from bnn_pynq_tpu_torch.ops.thresholds import (codes_to_values,
                                               multithreshold)


def conv_chain_plain(x, weights, thresholds, *, kernel: int, abits: int,
                     input_levels: bool = False) -> torch.Tensor:
    """Plain PyTorch version of `conv_chain` (same arguments)."""
    act = x
    for j, (w, thr) in enumerate(zip(weights, thresholds)):
        vals = act if (j == 0 and input_levels) else \
            codes_to_values(act, abits)
        patches = sliding_window(vals, kernel, kernel, 1)
        b, oh, ow, k = patches.shape
        acc = int_matmul_ref(patches.reshape(b * oh * ow, k), w.kn)
        act = multithreshold(acc, thr).reshape(b, oh, ow, w.kn.shape[1])
    return act


def conv_chain(x: torch.Tensor, weights: Sequence,
               thresholds: Sequence[torch.Tensor], *, kernel: int,
               abits: int, input_levels: bool = False) -> torch.Tensor:
    """Chained stride-1 VALID convs, every one thresholded.

    x: int8 [B, H, W, C0] activation codes, or int8 levels (e.g. the
       centred image) if `input_levels` — which applies to layer 0 only.
    weights: WeightMatrix per layer, levels [K²C_j, C_{j+1}] in (ki,kj,c)
       order. thresholds: int32 [nthr, C_{j+1}] per layer.
    Returns int8 codes [B, H - n(K-1), W - n(K-1), C_last], n = layers.
    """
    if len(thresholds) != len(weights):
        raise ValueError("one threshold table per chained layer")
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"x must be int8 [B, H, W, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    for j, (wt, thr) in enumerate(zip(weights, thresholds)):
        if wt.kn.shape[0] != kernel * kernel * c:
            raise ValueError(f"layer {j}: weight rows {wt.kn.shape[0]} != "
                             f"K²C {kernel * kernel * c}")
        if thr.dtype != torch.int32 or thr.ndim != 2 or \
                thr.shape[1] != wt.kn.shape[1]:
            raise ValueError(f"layer {j}: thresholds must be int32 "
                             f"[nthr, {wt.kn.shape[1]}]")
        h, w, c = h - kernel + 1, w - kernel + 1, wt.kn.shape[1]
        if h < 1 or w < 1:
            raise ValueError(f"layer {j}: {kernel}×{kernel} conv leaves no "
                             "valid region")
    if x.device.type == "cpu":
        return conv_chain_plain(x, weights, thresholds, kernel=kernel,
                                abits=abits, input_levels=input_levels)
    check_cuda_operands(x, weights, thresholds)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    act = x
    for j, (wt, thr) in enumerate(zip(weights, thresholds)):
        b, h, w, c = act.shape
        n = wt.kn.shape[1]
        out = torch.empty((b, h - kernel + 1, w - kernel + 1, n),
                          dtype=torch.int8, device=x.device)
        lib.call("bnn_conv_layer", act.data_ptr(), b, h, w, c, kernel,
                 int(j == 0 and input_levels), wt.nk32.data_ptr(),
                 wt.nk32.shape[1], n, wt.wsum.data_ptr(), thr.data_ptr(),
                 thr.shape[0], abits, out.data_ptr(), stream)
        conv_chain.launches.add()
        act = out
    return act


conv_chain.launches = _build.LaunchCounter()


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
    [nthr, N_i] per layer. Returns int8 codes [M, N_last].
    """
    if len(thresholds) != len(weights):
        raise ValueError("one threshold table per layer")
    check_chain(x_codes, weights, thresholds)
    if x_codes.device.type == "cpu":
        return dense_block_plain(x_codes, weights, thresholds, abits=abits,
                                 input_levels=input_levels)
    check_cuda_operands(x_codes, weights, thresholds)
    lib = _build.library()
    stream = torch.cuda.current_stream(x_codes.device).cuda_stream
    act = x_codes
    for j, (wt, thr) in enumerate(zip(weights, thresholds)):
        m, k = act.shape
        n = wt.kn.shape[1]
        out = torch.empty((m, n), dtype=torch.int8, device=act.device)
        lib.call("bnn_dense_block", act.data_ptr(), m, k,
                 int(j == 0 and input_levels), wt.nk32.data_ptr(),
                 wt.nk32.shape[1], n, wt.wsum.data_ptr(), thr.data_ptr(),
                 thr.shape[0], abits, out.data_ptr(), stream)
        dense_block.launches.add()
        act = out
    return act


dense_block.launches = _build.LaunchCounter()
