"""Whole quantized MLP in one kernel: codes in, float logits out.

Port of `bnn_pynq_tpu/ops/fused_mlp.py::fused_mlp_forward` and
`fused_mlp_forward_padded` (any batch: the kernel masks a ragged batch, so
nothing is padded).
Per layer: levels · weights → int32, MultiThreshold back to levels; the
last layer gives `float(acc) * out_scale + out_bias`. The CUDA kernel is
`csrc/dense_chain.cu` (entry `bnn_fused_mlp`): one launch, the dots on the
int8 tensor cores, the weights' `tiles` layout and `wsum` (models/params.py).
A block keeps 32 rows of every layer's activations in shared memory, so the
widest layer input it takes is about 4,000 codes (2,304 for CNV's tail);
beyond that the launcher returns an error and the wrapper raises.
"""

from __future__ import annotations

from typing import Sequence

import torch

from bnn_pynq_tpu_torch.ops import _build
from bnn_pynq_tpu_torch.ops.ref import int_matmul_ref
from bnn_pynq_tpu_torch.ops.thresholds import (codes_are_levels,
                                               codes_to_values,
                                               count_search, multithreshold)

MAX_LAYERS = 8   # csrc/dense_chain.cu kMaxLayers


def fused_mlp_forward_plain(x_codes, weights, thresholds, out_scale,
                            out_bias, *, abits: int,
                            input_levels: bool = False) -> torch.Tensor:
    """Plain PyTorch version of `fused_mlp_forward` (same arguments)."""
    act = x_codes if input_levels else codes_to_values(x_codes, abits)
    for i, w in enumerate(weights):
        acc = int_matmul_ref(act, w.kn)
        if i < len(weights) - 1:
            act = multithreshold(acc, thresholds[i])
            if not input_levels:
                act = codes_to_values(act, abits)
    return acc.to(torch.float32) * out_scale + out_bias


def fused_mlp_forward(x_codes: torch.Tensor, weights: Sequence,
                      thresholds: Sequence[torch.Tensor],
                      out_scale: torch.Tensor, out_bias: torch.Tensor, *,
                      abits: int,
                      input_levels: bool = False) -> torch.Tensor:
    """Run a whole quantized MLP.

    x_codes: int8 activation codes [B, K0] ({0,1} abits=1 / {0..3} abits=2
    / {0..15} abits=4, their own levels); with `input_levels` unsigned
    codes, their own levels, and so are the hidden layers'.
    weights: WeightMatrix per layer (models/params.py), levels [K_i, N_i].
    thresholds: int32 [nthr, N_i] for all but the last layer (15 rows:
    ascending in each channel on a CUDA tensor, as in `conv_stack`).
    out_scale/out_bias: float32 [ncls].
    Returns float32 logits [B, ncls]. A CPU tensor runs the plain version;
    a CUDA tensor launches the kernel.
    """
    if len(weights) != len(thresholds) + 1:
        raise ValueError("need one threshold table per non-final layer")
    check_chain(x_codes, weights, thresholds)
    ncls = weights[-1].kn.shape[1]
    for name, t in (("out_scale", out_scale), ("out_bias", out_bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (ncls,):
            raise ValueError(f"{name} must be float32 [{ncls}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if x_codes.device.type == "cpu":
        return fused_mlp_forward_plain(x_codes, weights, thresholds,
                                       out_scale, out_bias, abits=abits,
                                       input_levels=input_levels)
    check_cuda_operands(x_codes, weights, thresholds, out_scale, out_bias)
    out = torch.empty((x_codes.shape[0], ncls), dtype=torch.float32,
                      device=x_codes.device)
    lib = _build.library()
    nthr = thresholds[0].shape[0] if len(thresholds) else 1
    m, k0 = x_codes.shape
    lib.call("bnn_fused_mlp", x_codes.data_ptr(), m, k0,
             _build.pointer_array([w.tiles for w in weights]),
             _build.pointer_array([w.wsum for w in weights]),
             _build.pointer_array(list(thresholds) + [None]),
             _build.int_array([w.nk32.shape[1] for w in weights]),
             _build.int_array([w.kn.shape[1] for w in weights]),
             len(weights), nthr, abits,
             int(input_levels or codes_are_levels(abits)),
             out_scale.data_ptr(), out_bias.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(x_codes.device).cuda_stream)
    fused_mlp_forward.launches.add()
    if len(thresholds):
        count_search(thresholds[0])
    return out


fused_mlp_forward.launches = _build.LaunchCounter()


def fused_mlp_forward_padded(x_codes: torch.Tensor, weights: Sequence,
                             thresholds: Sequence[torch.Tensor],
                             out_scale: torch.Tensor, out_bias: torch.Tensor,
                             *, abits: int,
                             input_levels: bool = False) -> torch.Tensor:
    """JAX's any-batch entry: `fused_mlp_forward` itself, which takes any
    batch (its launches count there). JAX's `block_b` (the batch tile its
    padding rounds to) and `interpret` are TPU arguments, left out."""
    return fused_mlp_forward(x_codes, weights, thresholds, out_scale,
                             out_bias, abits=abits,
                             input_levels=input_levels)


def check_chain(x, weights, thresholds) -> None:
    """Shapes and dtypes of a dense chain (any device)."""
    if x.dtype != torch.int8 or x.ndim != 2:
        raise ValueError(f"x must be int8 [M, K0], got {x.dtype} "
                         f"{tuple(x.shape)}")
    k_in = x.shape[1]
    for i, w in enumerate(weights):
        if w.kn.shape[0] != k_in:
            raise ValueError(f"layer {i}: weight rows {w.kn.shape[0]} != "
                             f"input width {k_in}")
        k_in = w.kn.shape[1]
    for i, t in enumerate(thresholds):
        if t.dtype != torch.int32 or t.ndim != 2 or \
                t.shape[1] != weights[i].kn.shape[1]:
            raise ValueError(f"layer {i}: thresholds must be int32 "
                             f"[nthr, {weights[i].kn.shape[1]}], got "
                             f"{t.dtype} {tuple(t.shape)}")


def check_cuda_operands(x, weights, thresholds, *extra) -> None:
    """What the CUDA launchers take: one CUDA device, contiguous operands,
    the kernels' weight layouts, nthr in 1..3 or 15, at most MAX_LAYERS
    layers."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}; tensors must be "
                         "on the CPU (plain version) or on CUDA")
    if len(weights) > MAX_LAYERS:
        raise ValueError(f"{len(weights)} layers > kernel max {MAX_LAYERS}")
    nthrs = {t.shape[0] for t in thresholds}
    if len(nthrs) > 1 or not nthrs <= {1, 2, 3, 15}:
        raise ValueError(f"threshold counts {sorted(nthrs)}: the kernels "
                         "take one count, 1..3 or 15, for the whole chain")
    tensors = [x, *thresholds, *extra]
    for w in weights:
        tensors += [w.nk32, w.wsum, w.tiles]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernels take contiguous, 16-byte-aligned "
                             "tensors")
    for w in weights:
        k, n = w.kn.shape
        k32 = -(-k // 32) * 32              # models/params.py K_ALIGN_MMA
        if w.nk32.dtype != torch.int8 or tuple(w.nk32.shape) != (n, k32):
            raise ValueError(f"kernel weight layout nk32 must be int8 "
                             f"[{n}, {k32}], got {w.nk32.dtype} "
                             f"{tuple(w.nk32.shape)}")
        tiles = (-(-k // 128), n, 128)      # models/params.py K_TILE
        if w.tiles.dtype != torch.int8 or tuple(w.tiles.shape) != tiles:
            raise ValueError(f"kernel weight layout tiles must be int8 "
                             f"{list(tiles)}, got {w.tiles.dtype} "
                             f"{tuple(w.tiles.shape)}")
        if w.wsum.dtype != torch.int32 or tuple(w.wsum.shape) != (n,):
            raise ValueError(f"wsum must be int32 [{n}], got {w.wsum.dtype} "
                             f"{tuple(w.wsum.shape)}")
