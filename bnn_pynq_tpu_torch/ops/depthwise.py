"""Depthwise 3×3 conv with the MultiThreshold fused, SAME-padded.

Added for MobileNet-v1 W4A4 (models/config.py::mobilenet_v1); it replaces
no kernel of the JAX package, which runs no depthwise conv. One filter per
channel (groups = channels), stride 1 or 2, zero padding 1 on each side
(`models/config.py::DepthwiseSpec`'s kernel size and padding), an exact
int32 sum, then `thresholds.multithreshold` to int8 codes.
The padding is the level 0, which is the code 0 of the unsigned 4-bit
codes the kernel takes. CUDA kernel: `csrc/depthwise.cu` (`dw_kernel`,
entry `bnn_dw_conv`: 3×3, 4-bit codes, 15 thresholds). A CPU tensor runs
the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from bnn_pynq_tpu_torch.models.config import DepthwiseSpec
from bnn_pynq_tpu_torch.ops import _build
from bnn_pynq_tpu_torch.ops.thresholds import (codes_to_values,
                                               multithreshold)

K, PAD = DepthwiseSpec.kernel, DepthwiseSpec.pad


def out_size(n: int, stride: int) -> int:
    return (n + 2 * PAD - K) // stride + 1


def depthwise_acc(x_levels: torch.Tensor, w: torch.Tensor, *,
                  stride: int) -> torch.Tensor:
    """int32 accumulators [B, OH, OW, C] of levels [B, H, W, C] and filters
    w [9, C] (tap (ki, kj) major), zero-padded by 1 on each side."""
    b, h, wd, c = x_levels.shape
    oh, ow = out_size(h, stride), out_size(wd, stride)
    xp = torch.nn.functional.pad(x_levels.to(torch.int32),
                                 (0, 0, PAD, PAD, PAD, PAD))
    w32 = w.to(torch.int32)
    acc = torch.zeros((b, oh, ow, c), dtype=torch.int32,
                      device=x_levels.device)
    for ki in range(K):
        for kj in range(K):
            tap = xp[:, ki:ki + (oh - 1) * stride + 1:stride,
                     kj:kj + (ow - 1) * stride + 1:stride, :]
            acc += tap * w32[ki * K + kj]
    return acc


def depthwise_conv_plain(x, w, thr, *, stride: int,
                         abits: int) -> torch.Tensor:
    """Plain PyTorch version of `depthwise_conv` (same arguments)."""
    return multithreshold(
        depthwise_acc(codes_to_values(x, abits), w.kn, stride=stride), thr)


def depthwise_conv(x: torch.Tensor, w, thr: torch.Tensor, *, stride: int,
                   abits: int) -> torch.Tensor:
    """x: int8 codes [B, H, W, C]; w: WeightMatrix of levels [9, C];
    thr: int32 [nthr, C]. Returns int8 codes [B, OH, OW, C], OH =
    (H − 1) // stride + 1.

    The kernel takes stride 1 or 2, unsigned 4-bit codes (abits 4, 15
    thresholds) and C a multiple of 4 with C/4 dividing 256; the wrapper
    raises on anything else on a CUDA tensor."""
    kn = w.kn
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"x must be int8 [B, H, W, C], got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, h, wd, c = x.shape
    if kn.dtype != torch.int8 or kn.shape != (K * K, c):
        raise ValueError(f"filters must be int8 [{K * K}, {c}], got "
                         f"{kn.dtype} {tuple(kn.shape)}")
    if thr.dtype != torch.int32 or thr.ndim != 2 or thr.shape[1] != c:
        raise ValueError(f"thresholds must be int32 [nthr, {c}], got "
                         f"{thr.dtype} {tuple(thr.shape)}")
    if x.device.type == "cpu":
        return depthwise_conv_plain(x, w, thr, stride=stride, abits=abits)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if stride not in (1, 2) or abits != 4 or thr.shape[0] != 15 or \
            c % 4 or 256 % (c // 4):
        raise ValueError(
            f"the depthwise kernel takes stride 1 or 2, abits 4 with 15 "
            f"thresholds and C/4 dividing 256; got stride={stride}, "
            f"abits={abits}, nthr={thr.shape[0]}, C={c}")
    for t in (x, kn, thr):
        if t.device != x.device or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError("the kernel takes contiguous, 16-byte-aligned "
                             "tensors on one device")
    oh, ow = out_size(h, stride), out_size(wd, stride)
    out = torch.empty((b, oh, ow, c), dtype=torch.int8, device=x.device)
    _build.library().call(
        "bnn_dw_conv", x.data_ptr(), b, h, wd, c, stride, kn.data_ptr(),
        thr.data_ptr(), thr.shape[0], abits, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    depthwise_conv.launches.add()
    return out


depthwise_conv.launches = _build.LaunchCounter()
