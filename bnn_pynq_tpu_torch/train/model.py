"""The float training model: a quantized network that mirrors the integer
inference plan layer for layer.

Port of `bnn_pynq_tpu/train/model.py` (flax) to `torch.nn.Module`s.
Structure per compute layer: Conv/Dense (quantized weights, no bias) →
BatchNorm → activation quantizer; pools run on quantized codes. The last
compute layer is Conv/Dense → BatchNorm with no quantizer; its float
output feeds the loss.

The parameters keep flax's layout and names, which the compiler
(`compiler/finnthesizer.py`) and the checkpoints read: `quant_{i}` /
`bn_{i}` by position in `config.layers`; conv kernels HWIO, dense kernels
(in, out); `scale` / `bias` under params, `mean` / `var` under
batch_stats. `QuantNet.load_variables` takes flax's nested dicts and
`QuantNet.variables` returns them.

Flax semantics kept on purpose:
- BatchNorm in training normalises with the batch's mean and its *biased*
  variance max(0, E[x²] − E[x]²) and updates the running statistics as
  ra = 0.9·ra + 0.1·batch (flax `momentum=0.9`). `torch.nn.BatchNorm2d`
  would store the unbiased variance, so the statistics are kept here.
- The input arrives NHWC (`train/data.py::train_inputs`); the interior is
  NCHW for `conv2d`, and the flatten in front of a dense layer is taken in
  NHWC order, as flax's reshape takes it.
- The pool is `max_pool2d` (VALID, stride = window) on ±1 codes, where
  ties are the rule: its gradient goes to the first maximal element of the
  window in row-major order, the element XLA's `select_and_scatter` picks.
- Kernels are Glorot-uniform (flax's `glorot_uniform`, fans of a conv
  kh·kw·cin and kh·kw·cout) drawn from an explicit CPU `torch.Generator`,
  so the same seed gives the same network on every device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bnn_pynq_tpu_torch.models.config import (ConvSpec, NetworkConfig,
                                              PoolSpec)
from bnn_pynq_tpu_torch.train.quant import (binarize_stochastic,
                                            quantize_activations,
                                            quantize_weights)

# Lasagne BatchNormLayer defaults (reference training stack): eps=1e-4,
# alpha=0.1 ⇒ flax momentum=0.9 (torch's convention would call it 0.1).
# The compiler folds with BN_EPS.
BN_EPS = 1e-4
BN_MOMENTUM = 0.9


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """Float32 convolutions and matrix products at full float32 precision
    (no TF32) inside the block, the earlier settings restored after it.
    cuDNN runs float32 convolutions in TF32 by default; the trainer runs
    its forward and backward passes inside this block. Not
    `torch.backends.cudnn.flags(allow_tf32=False)`: that also sets every
    flag it is not given to its default, `enabled=False` among them."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _glorot_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """flax `glorot_uniform` (variance_scaling(1, fan_avg, uniform)):
    U(-l, l) with l = sqrt(6 / (fan_in + fan_out)); the receptive field of
    a kernel (kh, kw, cin, cout) multiplies both fans."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


class QuantDense(nn.Module):
    """x @ quantize(kernel), kernel (in, out)."""

    def __init__(self, in_features: int, features: int, wbits: int,
                 generator: torch.Generator):
        super().__init__()
        self.wbits = wbits
        self.kernel = nn.Parameter(
            _glorot_uniform((in_features, features), generator))

    def forward(self, x):
        return x @ quantize_weights(self.kernel, self.wbits)


class QuantConv(nn.Module):
    """VALID convolution with a quantized HWIO kernel, on NCHW."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int,
                 wbits: int, generator: torch.Generator):
        super().__init__()
        self.stride = stride
        self.wbits = wbits
        self.kernel = nn.Parameter(_glorot_uniform(
            (kernel, kernel, in_ch, features), generator))

    def forward(self, x):
        wq = quantize_weights(self.kernel, self.wbits)
        return F.conv2d(x, wq.permute(3, 2, 0, 1), stride=self.stride)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the channel axis (dim 1 of NC or NCHW).

    Training: batch mean and biased variance max(0, E[x²] − E[x]²), both in
    the gradient; running statistics updated in place as
    ra = BN_MOMENTUM·ra + (1 − BN_MOMENTUM)·batch. Evaluation: the running
    statistics. Both: (x − mean)·(rsqrt(var + eps)·scale) + bias."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def batch_moments(self, x):
        """E[x] and E[x²] per channel over the batch (and the map)."""
        axes = [d for d in range(x.ndim) if d != 1]
        return x.mean(axes), torch.square(x).mean(axes)

    def forward(self, x, train: bool = False):
        if train:
            mean, mean2 = self.batch_moments(x)
            var = torch.maximum(mean2 - torch.square(mean),
                                mean2.new_zeros(()))
            with torch.no_grad():
                m = BN_MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        return (x - mean.view(shape)) * mul.view(shape) + \
            self.bias.view(shape)


class QuantNet(nn.Module):
    """Float-forward quantized network for a NetworkConfig.

    `forward(x, train)`: x is NHWC float (or (B, features) for a bipolar
    net), as `train/data.py::train_inputs` gives it. `stochastic=True` with
    `train=True` binarizes 1-bit activations stochastically from the
    `generator` passed to `forward` (on x's device). Evaluation and the
    compiler use the deterministic quantizer. `generator` here seeds the
    initial kernels (a CPU generator; seed 0 when None)."""

    def __init__(self, config: NetworkConfig, stochastic: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.stochastic = stochastic
        specs = config.layers
        self.last_compute = max(i for i, s in enumerate(specs)
                                if not isinstance(s, PoolSpec))
        h, w, c = config.input_shape
        flat = config.input_kind == "bipolar"
        feats = h * w * c
        layers = {}
        for i, spec in enumerate(specs):
            if isinstance(spec, PoolSpec):
                h, w = h // spec.window, w // spec.window
                continue
            if isinstance(spec, ConvSpec):
                layers[f"quant_{i}"] = QuantConv(
                    c, spec.out_ch, spec.kernel, spec.stride, config.wbits,
                    generator)
                h = (h - spec.kernel) // spec.stride + 1
                w = (w - spec.kernel) // spec.stride + 1
                c = spec.out_ch
                out = c
            else:
                in_features = feats if flat else h * w * c
                layers[f"quant_{i}"] = QuantDense(
                    in_features, spec.out_features, config.wbits, generator)
                flat, feats = True, spec.out_features
                out = feats
            layers[f"bn_{i}"] = BatchNorm(out)
        self.layers = nn.ModuleDict(layers)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        if cfg.input_kind == "bipolar":
            x = x.reshape(x.shape[0], -1)
        elif x.ndim == 4:
            x = x.permute(0, 3, 1, 2)                    # NHWC → NCHW
        for i, spec in enumerate(cfg.layers):
            if isinstance(spec, PoolSpec):
                x = F.max_pool2d(x, spec.window, spec.window)
                continue
            if not isinstance(spec, ConvSpec) and x.ndim > 2:
                x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            x = self.layers[f"quant_{i}"](x)
            x = self.layers[f"bn_{i}"](x, train)
            if i != self.last_compute:
                if self.stochastic and train and cfg.abits == 1:
                    if generator is None:
                        raise ValueError("stochastic training needs a "
                                         "generator on the input's device")
                    x = binarize_stochastic(x, generator)
                else:
                    x = quantize_activations(x, cfg.abits)
        return x

    # -- flax's variable layout ------------------------------------------------

    def variables(self, state: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Dict[str, Dict]:
        """{"params": {quant_i: {kernel}, bn_i: {scale, bias}},
        "batch_stats": {bn_i: {mean, var}}} as float32 numpy arrays, from
        the module or from a `state_dict()` snapshot of it."""
        if state is None:
            state = self.state_dict()
        out = {"params": {}, "batch_stats": {}}
        for key, value in state.items():
            _, layer, leaf = key.split(".")
            kind = "batch_stats" if leaf in ("mean", "var") else "params"
            out[kind].setdefault(layer, {})[leaf] = \
                value.detach().cpu().numpy().copy()
        return out

    def load_variables(self, params: Mapping, batch_stats: Mapping) -> None:
        """Copy flax-layout params / batch_stats (nested mappings of arrays)
        into the module, on its device. Every leaf must be present with
        the module's shape."""
        trees = {"params": params, "batch_stats": batch_stats}
        with torch.no_grad():
            for key, t in self.state_dict().items():
                _, layer, leaf = key.split(".")
                kind = "batch_stats" if leaf in ("mean", "var") else "params"
                v = np.array(trees[kind][layer][leaf], np.float32)
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f"{kind}/{layer}/{leaf}: shape "
                                     f"{v.shape} != {tuple(t.shape)}")
                t.copy_(torch.from_numpy(v))
