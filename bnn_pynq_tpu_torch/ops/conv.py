"""Sliding window (im2col) and max-pool on NHWC tensors.

Port of `bnn_pynq_tpu/ops/conv.py::sliding_window` and `::maxpool2d`.
Patch order along the last axis is (ki, kj, c): element (ki·kw + kj)·C + c,
which equals a plain reshape of HWIO weights to [kh·kw·C, O].
"""

from __future__ import annotations

import torch


def sliding_window(x: torch.Tensor, kh: int, kw: int,
                   stride: int = 1) -> torch.Tensor:
    """x [B, H, W, C] → patches [B, OH, OW, kh·kw·C], VALID padding."""
    _, h, w, _ = x.shape
    oh = (h - kh) // stride + 1
    ow = (w - kw) // stride + 1
    parts = [x[:, ki:ki + (oh - 1) * stride + 1:stride,
               kj:kj + (ow - 1) * stride + 1:stride, :]
             for ki in range(kh) for kj in range(kw)]
    return torch.cat(parts, dim=-1)


def maxpool2d(codes: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max-pool on activation codes [B, H, W, C] (VALID: a ragged edge is
    dropped). Quantization is monotone, so pooling codes equals pooling
    pre-activations."""
    b, h, w, c = codes.shape
    oh, ow = h // window, w // window
    x = codes[:, :oh * window, :ow * window, :]
    return x.reshape(b, oh, window, ow, window, c).amax(dim=(2, 4))
