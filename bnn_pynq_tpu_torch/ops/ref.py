"""Exact integer matmul and conv — the reference the kernels are held
against.

Port of `bnn_pynq_tpu/ops/ref.py`: `int_matmul_ref`, `int_matmul_wide_ref`,
`binary_matmul_ref` (the same dot on ±1 operands), `binary_layer_ref` (the
dot and a MultiThreshold), `conv2d_int_ref` and `maxpool2d_codes_ref`.
Operands are small
integers: |a| ≤ 128 (raw image) or ≤ 3 (levels), |w| ≤ 3, so
|acc| ≤ 27·128·3 for CNV's first conv and ≤ 2304·9 elsewhere.

- CPU: an int32 matmul, accumulating in int32 as the JAX reference does
  (`preferred_element_type=int32`); no partial sum comes near 2^31.
  (int64 is as exact and about 5× slower here.)
- CUDA: torch has no integer matmul there, so a float64 matmul rounded
  back to int32. Every product and partial sum is an integer far below
  2^53, so float64 holds it exactly (TF32 does not apply to float64).
"""

from __future__ import annotations

import torch

from bnn_pynq_tpu_torch.ops._build import LaunchCounter
from bnn_pynq_tpu_torch.ops.thresholds import multithreshold


def int_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] integer · w [K, N] integer → int32 [M, N], exact. Counts
    its calls in `int_matmul_ref.calls`."""
    int_matmul_ref.calls.add()
    if a.device.type == "cuda":
        return torch.matmul(a.to(torch.float64),
                            w.to(torch.float64)).round_().to(torch.int32)
    return torch.matmul(a.to(torch.int32), w.to(torch.int32))


int_matmul_ref.calls = LaunchCounter()


def int_matmul_wide_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul of operands past int8 (int32 accumulators
    multiplied again, say). JAX's casts its operands to int32 where its
    `int_matmul_ref` casts them to int8; `int_matmul_ref` here casts to
    nothing narrower than int32 (the CPU) or float64 (the card), so this is
    the same product, exact while every partial sum fits int32 (the CPU,
    which wraps past it as JAX's int32 dot does) or 2^53 (the card)."""
    return int_matmul_ref(a, w)


def binary_matmul_ref(a_pm1: torch.Tensor,
                      w_pm1: torch.Tensor) -> torch.Tensor:
    """Binary (±1) matmul reference: int32 exact dot of ±1 operands."""
    return int_matmul_ref(a_pm1, w_pm1)


def binary_layer_ref(a_vals: torch.Tensor, w_vals: torch.Tensor,
                     thr: torch.Tensor) -> torch.Tensor:
    """A dense quantized layer: integer levels [M, K] · integer levels
    [K, N], then the MultiThreshold of thr [nthr, N] → int8 codes [M, N]
    (the golden model of the fused matmul-and-threshold unit)."""
    return multithreshold(int_matmul_ref(a_vals, w_vals), thr)


def conv2d_int_ref(x_vals: torch.Tensor, w_vals: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """Exact integer VALID conv: x [B, H, W, C] integer levels · w
    [kh, kw, C, O] (HWIO) integer levels → int32 [B, OH, OW, O].

    A sliding window and `int_matmul_ref`, not a float conv: cuDNN runs a
    float32 conv in TF32 by default, which is not exact."""
    # conv.py imports this module (through matmul.py), so not at the top
    from bnn_pynq_tpu_torch.ops.conv import sliding_window
    kh, kw, c, o = w_vals.shape
    patches = sliding_window(x_vals, kh, kw, stride)
    b, oh, ow, k = patches.shape
    acc = int_matmul_ref(patches.reshape(b * oh * ow, k),
                         w_vals.reshape(k, o))
    return acc.reshape(b, oh, ow, o)


def maxpool2d_codes_ref(codes: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max-pool of activation codes [B, H, W, C] over window × window
    tiles, VALID (a ragged edge is dropped): the elementwise maximum of the
    window² strided slices. Quantization is monotone, so this equals
    pooling before it; on binary codes max is OR."""
    _, h, w, _ = codes.shape
    oh, ow = h // window, w // window
    out = codes[:, :oh * window:window, :ow * window:window, :]
    for i in range(window):
        for j in range(window):
            if i or j:
                out = torch.maximum(out, codes[:, i:oh * window:window,
                                               j:ow * window:window, :])
    return out
