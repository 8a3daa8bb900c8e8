"""Straight-through-estimator quantizers on `torch.autograd.Function`s.

Port of `bnn_pynq_tpu/train/quant.py`, whose three `jax.custom_vjp`s
become the Functions `_Binarize`, `_Quantize2` and `_binarize_stochastic`.
`binarize(x)` and `quantize2(x)` are called as JAX calls them; each also
carries its Function's `.apply`. The forward passes repeat JAX's
operations in JAX's order, so float32 results are bitwise the reference's.

Quantization grids (the compiler and the integer engine rely on these
exact boundary semantics):

- 1-bit: q = +1 if x >= 0 else -1 (boundary on the >= side, matching the
  integer `acc >= thr` epilogue; packing then stores bit = (q > 0)).
- 2-bit: levels {-1, -1/3, +1/3, +1}; code c = clip(floor((3x+3)/2 + 0.5),
  0, 3): round half UP (`torch.round` rounds half to even and is wrong
  here), giving decision boundaries at x ∈ {-2/3, 0, +2/3} with the upper
  level taken at the boundary.

Backward: hard-tanh STE — the gradient passes where |x| <= 1 and is zero
outside.
"""

from __future__ import annotations

import numpy as np
import torch


def _ste_bwd_mask(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) <= 1.0, g, 0.0)


class _Binarize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return _ste_bwd_mask(x, g)


class _Quantize2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        c = torch.clamp(torch.floor((3.0 * x + 3.0) / 2.0 + 0.5), 0.0, 3.0)
        return ((2.0 * c - 3.0) / 3.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return _ste_bwd_mask(x, g)


def binarize(x: torch.Tensor) -> torch.Tensor:
    """±1 deterministic binarization with hard-tanh STE.

    x >= 0 → +1 (NOT sign(x)): matches the `acc >= thr` comparison the
    compiler folds batch-norm into."""
    return _Binarize.apply(x)


def quantize2(x: torch.Tensor) -> torch.Tensor:
    """2-bit quantization to {-1, -1/3, 1/3, 1} with hard-tanh STE."""
    return _Quantize2.apply(x)


binarize.apply = _Binarize.apply
quantize2.apply = _Quantize2.apply


class _binarize_stochastic(torch.autograd.Function):  # noqa: N801
    """Stochastic binarization: P(+1) = hard_sigmoid((x+1)/2), u ~ U[0,1).
    No gradient flows to `u`."""

    @staticmethod
    def forward(ctx, x, u):
        ctx.save_for_backward(x)
        p = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
        return torch.where(u < p, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return _ste_bwd_mask(x, g), None


def binarize_stochastic(x: torch.Tensor,
                        generator: torch.Generator) -> torch.Tensor:
    """Draws u ~ U[0, 1) on `x`'s device from `generator` (which must live
    on that device) and binarizes stochastically."""
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    return _binarize_stochastic.apply(x, u)


def quantize_weights(w: torch.Tensor, wbits: int) -> torch.Tensor:
    """Weight quantizer used in the forward pass of training."""
    if wbits == 1:
        return binarize.apply(w)
    if wbits == 2:
        return quantize2.apply(w)
    raise ValueError(f"unsupported wbits={wbits}")


def quantize_activations(x: torch.Tensor, abits: int) -> torch.Tensor:
    if abits == 1:
        return binarize.apply(x)
    if abits == 2:
        return quantize2.apply(x)
    raise ValueError(f"unsupported abits={abits}")


def weight_levels(wq, wbits: int) -> np.ndarray:
    """Float quantized weights → integer levels (for the param compiler).

    wbits=1: ±1.0 → ±1;  wbits=2: {-1,-1/3,1/3,1} → {-3,-1,1,3}."""
    if isinstance(wq, torch.Tensor):
        wq = wq.detach().cpu().numpy()
    wq = np.asarray(wq, dtype=np.float64)
    if wbits == 1:
        return np.where(wq > 0, 1, -1).astype(np.int8)
    return np.rint(wq * 3).astype(np.int8)
