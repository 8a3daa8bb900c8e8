"""Direct (no-im2col) quantized convs: one layer, or several chained.

Ports of `bnn_pynq_tpu/ops/conv_direct.py`:
- `conv2d_direct` ← `conv2d_direct`: one VALID K×K conv of activation
  codes, thresholded to codes, or int32 accumulators without thresholds.
  stride > 1 takes thresholds and runs, as in JAX, on prebuilt patches:
  the kernel then sees a 1×1 conv over the `sliding_window` patches.
- `conv_chain_direct` ← `conv_chain_direct`: chained stride-1 VALID convs,
  every one thresholded; the intermediate codes stay on chip.

CUDA kernels: `csrc/conv_direct.cu`, both on the int8 tensor cores, on the
weights' `nk32` layout and `wsum`. `bnn_conv_direct` is the implicit GEMM
of `csrc/conv_tile.cuh`, shared with `conv_chain`; a conv whose kernel
covers its input goes to `csrc/dense_chain.cu` as one dense layer on the
weights' `tiles`. `bnn_conv_chain_direct` runs the same inner loop layer
after layer on whole images held in shared memory, the codes between the
layers never leaving it. The JAX kernels' pitch grid, batch padding and
pre-overlapped windows are TPU layout devices: the port computes and
returns the valid region only and takes any batch.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bnn_pynq_tpu_torch.ops import _build
from bnn_pynq_tpu_torch.ops.conv import sliding_window
from bnn_pynq_tpu_torch.ops.conv_stack import conv_chain
from bnn_pynq_tpu_torch.ops.fused_mlp import check_cuda_operands
from bnn_pynq_tpu_torch.ops.ref import conv2d_int_ref
from bnn_pynq_tpu_torch.ops.thresholds import (codes_are_levels,
                                               codes_to_values,
                                               count_search, multithreshold)


def _conv_levels(vals, w, thr, kernel: int, stride: int = 1):
    """Levels [B, H, W, C] → int32 accumulators, or codes with `thr`."""
    hwio = w.kn.reshape(kernel, kernel, vals.shape[-1], w.kn.shape[1])
    acc = conv2d_int_ref(vals, hwio, stride)
    return acc if thr is None else multithreshold(acc, thr)


def conv2d_direct_plain(x_codes, w, thr=None, *, kernel: int, abits: int,
                        stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version of `conv2d_direct` (same arguments)."""
    return _conv_levels(codes_to_values(x_codes, abits), w, thr, kernel,
                        stride)


def conv_chain_direct_plain(x, weights, thresholds, *, kernel: int,
                            abits: int,
                            input_levels: bool = False) -> torch.Tensor:
    """Plain PyTorch version of `conv_chain_direct` (same arguments)."""
    act = x
    for j, (w, thr) in enumerate(zip(weights, thresholds)):
        vals = act if (j == 0 and input_levels) else \
            codes_to_values(act, abits)
        act = _conv_levels(vals, w, thr, kernel)
    return act


def _check_input(x) -> None:
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"x must be int8 [B, H, W, C], got {x.dtype} "
                         f"{tuple(x.shape)}")


def _check_layer(j, w, thr, c: int, kernel: int) -> None:
    if w.kn.shape[0] != kernel * kernel * c:
        raise ValueError(f"layer {j}: weight rows {w.kn.shape[0]} != K²C "
                         f"{kernel * kernel * c}")
    if thr is not None and (thr.dtype != torch.int32 or thr.ndim != 2 or
                            thr.shape[1] != w.kn.shape[1]):
        raise ValueError(f"layer {j}: thresholds must be int32 "
                         f"[nthr, {w.kn.shape[1]}]")


def conv2d_direct(x_codes: torch.Tensor, w, thr: Optional[torch.Tensor] = None,
                  *, kernel: int, abits: int, stride: int = 1) -> torch.Tensor:
    """One VALID K×K conv.

    x_codes: int8 activation codes [B, H, W, C] ({0,1} abits=1, {0..3}
       abits=2).
    w: WeightMatrix (models/params.py), levels [K²·C, O] in (ki,kj,c) order.
    thr: int32 [nthr, O], or None for int32 accumulators (stride 1 only);
       15 rows ascending in each channel on a CUDA tensor (searched).
    Returns [B, OH, OW, O]: int8 codes, or int32 without `thr`.

    On a CUDA tensor the kernel keeps, in shared memory, the input rows of
    32 output pixels beside at least 8 weight columns (or, for a conv whose
    kernel covers its input, 32 rows of K²·C codes): a layer too wide for
    that (K²·C beyond about 3,500 on a covered map) makes the launcher
    return an error, and this wrapper raises.
    """
    _check_input(x_codes)
    _check_layer(0, w, thr, x_codes.shape[-1], kernel)
    if stride != 1 and thr is None:
        raise ValueError("strided conv2d_direct requires thresholds (the "
                         "accumulator path is stride-1 only)")
    if min(x_codes.shape[1:3]) < kernel:
        raise ValueError(f"a {kernel}×{kernel} conv leaves no valid region")
    if x_codes.device.type == "cpu":
        return conv2d_direct_plain(x_codes, w, thr, kernel=kernel,
                                   abits=abits, stride=stride)
    check_cuda_operands(x_codes, [w], [] if thr is None else [thr])
    k32 = w.nk32.shape[1]
    if stride != 1:
        # a 1×1 conv over the patches, their K²·C channels padded to the
        # weights' k32 (any code will do: the weights are zero there), so
        # that the kernel copies whole rows and gathers nothing
        x_codes = sliding_window(x_codes, kernel, kernel, stride)
        if x_codes.shape[-1] != k32:
            x_codes = torch.nn.functional.pad(
                x_codes, (0, k32 - x_codes.shape[-1]))
        kernel = 1
    b, h, wd, c = x_codes.shape
    n = w.kn.shape[1]
    out = torch.empty((b, h - kernel + 1, wd - kernel + 1, n),
                      dtype=torch.int8 if thr is not None else torch.int32,
                      device=x_codes.device)
    stream = torch.cuda.current_stream(x_codes.device).cuda_stream
    _build.library().call(
        "bnn_conv_direct", x_codes.data_ptr(), b, h, wd, c, kernel,
        w.nk32.data_ptr(), w.tiles.data_ptr(), k32, n, w.wsum.data_ptr(),
        None if thr is None else thr.data_ptr(),
        0 if thr is None else thr.shape[0], abits,
        int(codes_are_levels(abits)), out.data_ptr(), stream)
    conv2d_direct.launches.add()
    if thr is not None:
        count_search(thr)
    return out


conv2d_direct.launches = _build.LaunchCounter()


def conv_chain_direct(x: torch.Tensor, weights: Sequence,
                      thresholds: Sequence[torch.Tensor], *, kernel: int,
                      abits: int, input_levels: bool = False) -> torch.Tensor:
    """Several chained stride-1 VALID convs in one kernel launch.

    x: int8 [B, H, W, C0] activation codes, or int8 levels (e.g. the
       centred image) if `input_levels`, which applies to layer 0 only.
    weights: WeightMatrix per layer, levels [K²·C_j, C_{j+1}] in (ki,kj,c)
       order. thresholds: int32 [nthr, C_{j+1}] per layer, one nthr for
       all layers (each layer quantizes; the chain never ends a network).
    Returns int8 codes [B, H - n(K-1), W - n(K-1), C_last], n = layers.

    On a CUDA tensor the kernel keeps whole images in shared memory, layer
    after layer, beside a chunk of each layer's weights; that holds at every
    CNV shape. Where not even one image fits (a 64×64×64 map, say) the
    launcher declines and the chain runs one layer a launch through
    `ops/conv_stack.py::conv_chain`, the codes between the layers in device
    memory; `conv_chain_direct.layerwise` counts the calls that took that
    branch (they add to `conv_chain.launches`, not to this wrapper's).
    """
    _check_input(x)
    if len(thresholds) != len(weights):
        raise ValueError("one threshold table per chained layer")
    if not weights:
        raise ValueError("a chain needs at least one layer")
    chans = [x.shape[-1]] + [w.kn.shape[1] for w in weights]
    for j, (w, thr) in enumerate(zip(weights, thresholds)):
        _check_layer(j, w, thr, chans[j], kernel)
    if len({t.shape[0] for t in thresholds}) != 1:
        raise ValueError("every chained layer must have the same number of "
                         "thresholds")
    n_layers = len(weights)
    if min(x.shape[1:3]) - n_layers * (kernel - 1) < 1:
        raise ValueError("chain erases the spatial extent")
    if x.device.type == "cpu":
        return conv_chain_direct_plain(x, weights, thresholds, kernel=kernel,
                                       abits=abits,
                                       input_levels=input_levels)
    check_cuda_operands(x, weights, thresholds)
    b, h, wd, c = x.shape
    shrink = n_layers * (kernel - 1)
    out = torch.empty((b, h - shrink, wd - shrink, chans[-1]),
                      dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launched = _build.library().call(
        "bnn_conv_chain_direct", x.data_ptr(), b, h, wd, c, kernel,
        int(input_levels), _build.pointer_array([w.nk32 for w in weights]),
        _build.int_array([w.nk32.shape[1] for w in weights]),
        _build.int_array(chans[1:]),
        _build.pointer_array([w.wsum for w in weights]),
        _build.pointer_array(thresholds), n_layers, thresholds[0].shape[0],
        abits, out.data_ptr(), stream, may_decline=True)
    if not launched:
        conv_chain_direct.layerwise.add()
        return conv_chain(x, weights, thresholds, kernel=kernel, abits=abits,
                          input_levels=input_levels)
    conv_chain_direct.launches.add()
    return out


conv_chain_direct.launches = _build.LaunchCounter()
# the calls that ran a layer a launch instead (no image fits on chip)
conv_chain_direct.layerwise = _build.LaunchCounter()
