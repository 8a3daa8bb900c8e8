"""Sliding window (im2col), max-pool and the packed conv on NHWC tensors.

Port of `bnn_pynq_tpu/ops/conv.py`: `sliding_window`,
`conv_weight_matrix`, `maxpool2d`, `conv2d_packed` and
`maxpool2d_packed_or`. Patch order along the last
axis is (ki, kj, c): element (ki·kw + kj)·C + c, which equals a plain
reshape of HWIO weights to [kh·kw·C, O].
"""

from __future__ import annotations

from typing import Optional

import torch

from bnn_pynq_tpu_torch.ops import packing
from bnn_pynq_tpu_torch.ops.matmul import packed_matmul_padded


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


def conv_weight_matrix(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO conv weights [kh, kw, C, O] → the matmul matrix [kh·kw·C, O],
    rows in the (ki, kj, c) order of `sliding_window`'s patches."""
    kh, kw, c, o = w_hwio.shape
    return w_hwio.reshape(kh * kw * c, o)


def maxpool2d(codes: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max-pool on activation codes [B, H, W, C] (VALID: a ragged edge is
    dropped). Quantization is monotone, so pooling codes equals pooling
    pre-activations."""
    b, h, w, c = codes.shape
    oh, ow = h // window, w // window
    x = codes[:, :oh * window, :ow * window, :]
    return x.reshape(b, oh, window, ow, window, c).amax(dim=(2, 4))


def pack_along_last(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Activation codes → int32 words along the last axis (1-bit: the bit
    is code > 0; 2-bit: the code itself)."""
    if bits == 1:
        return packing.pack_bits(codes, axis=-1)
    return packing.pack_codes2(codes, axis=-1)


def conv2d_packed(x_codes: torch.Tensor, w_words: torch.Tensor,
                  thr: Optional[torch.Tensor] = None, *, kernel: int,
                  stride: int = 1, bits: int = 1,
                  route: str = "mxu") -> torch.Tensor:
    """Quantized conv as sliding window + packed matmul.

    x_codes: int8 codes [B, H, W, C] ({0,1} for bits=1, {0..3} for bits=2).
    w_words: int32 [Kw, O] packed along K = kernel²·C (order ki, kj, c).
    thr: int32 [nthr, O] or None (None → int32 accumulators out).
    Returns [B, OH, OW, O] codes (int8) or accumulators (int32).
    """
    b, _, _, c = x_codes.shape
    k = kernel * kernel * c
    if c % (packing.WORD_BITS // bits) == 0:
        # pack along C first, then window the words: no word straddles a
        # window position, so this equals packing the (ki,kj,c) patches,
        # and the kernel²-fold im2col copy moves 8×/16× fewer bytes
        patches = sliding_window(pack_along_last(x_codes, bits), kernel,
                                 kernel, stride)
        _, oh, ow, kw = patches.shape
        a_words = patches.reshape(b * oh * ow, kw)
    else:
        patches = sliding_window(x_codes, kernel, kernel, stride)
        _, oh, ow, _ = patches.shape
        a_words = pack_along_last(patches.reshape(b * oh * ow, k), bits)
    out = packed_matmul_padded(a_words, w_words, thr, k=k, bits=bits,
                               route=route)
    return out.reshape(b, oh, ow, out.shape[-1])


def maxpool2d_packed_or(packed: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Binary max-pool directly on packed words: bitwise OR over the
    window. packed: int32 words [B, H, W, Cw] (VALID)."""
    b, h, w, cw = packed.shape
    oh, ow = h // window, w // window
    x = packed[:, :oh * window, :ow * window, :].reshape(
        b, oh, window, ow, window, cw)
    out = x[:, :, 0, :, 0, :]
    for i in range(window):
        for j in range(window):
            if i or j:
                out = out | x[:, :, i, :, j, :]
    return out
