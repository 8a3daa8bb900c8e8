"""The parameter compiler ("finnthesizer"): trained float parameters in,
integer inference parameters out. Numpy only.

Ported from `bnn_pynq_tpu/compiler/finnthesizer.py`, array for array:

1. quantizes weights exactly as the training forward pass does
   (replicating its float32 boundary arithmetic),
2. folds each BatchNorm into per-channel integer thresholds on the
   integer accumulator, `code = sum_t (acc >= T_t)`. A negative BN slope
   flips the channel's integer weight column, a zero slope gives sentinel
   thresholds,
3. folds the final BatchNorm into a per-class float (scale, bias) pair
   applied to the last layer's int32 accumulators,
4. packs integer weights along K into uint32 words.

Exactness argument: the float model's pre-activation is
y = gamma*(s*d - mu)/sigma + beta, where d is the integer accumulator and
s the static product of weight and activation scales. For gamma > 0,
y >= theta <=> d >= (sigma*(theta - beta)/gamma + mu)/s, and since d is
an integer the right side can be replaced by its ceiling, computed once
in float64.

`params` / `batch_stats` are nested mappings named `quant_{i}` /
`bn_{i}` (the training model's contract): plain dicts of numpy arrays,
or any tree with `.unfreeze()`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from bnn_pynq_tpu_torch.compiler.artifacts import CompiledNetwork
from bnn_pynq_tpu_torch.models.config import NetworkConfig, PoolSpec
from bnn_pynq_tpu_torch.ops import packing
from bnn_pynq_tpu_torch.ops.thresholds import THR_ALWAYS, THR_NEVER
from bnn_pynq_tpu_torch.train.model import BN_EPS


def _quantize_weights_np(w: np.ndarray, wbits: int) -> np.ndarray:
    """Integer weight levels, replicating train/quant.py float32 forward
    boundary-exactly (binarize: w>=0→+1; quantize2 via floor(v+0.5))."""
    w32 = w.astype(np.float32)
    if wbits == 1:
        return np.where(w32 >= 0, 1, -1).astype(np.int8)
    c = np.clip(np.floor((np.float32(3.0) * w32 + np.float32(3.0))
                         / np.float32(2.0) + np.float32(0.5)), 0, 3)
    return (2 * c.astype(np.int8) - 3).astype(np.int8)


def _activation_boundaries(abits: int) -> np.ndarray:
    """Float thresholds of the activation quantizer (ascending)."""
    if abits == 1:
        return np.array([0.0], dtype=np.float64)
    if abits == 2:
        return np.array([-2.0 / 3.0, 0.0, 2.0 / 3.0], dtype=np.float64)
    raise ValueError(f"unsupported abits={abits}")


def _fold_bn_to_thresholds(gamma, beta, mean, var, s: float,
                           boundaries: np.ndarray):
    """Per-channel integer thresholds + flip mask.

    Returns (thr int32 [nthr, N], flip bool [N]).
    y(d) = γ(s·d − μ)/σ + β;  code = Σ_t 1{y >= θ_t}.
    """
    gamma = gamma.astype(np.float64)
    beta = beta.astype(np.float64)
    mean = mean.astype(np.float64)
    sigma = np.sqrt(var.astype(np.float64) + BN_EPS)
    n = gamma.shape[0]
    nthr = boundaries.shape[0]
    thr = np.zeros((nthr, n), dtype=np.int64)
    flip = gamma < 0
    with np.errstate(divide="ignore", invalid="ignore"):
        for t, theta in enumerate(boundaries):
            tau = (sigma * (theta - beta) / gamma + mean) / s
            pos = np.ceil(tau)                  # γ>0: d >= ceil(tau)
            neg = np.ceil(-tau)                 # γ<0: d' = -d >= ceil(-tau)
            row = np.where(flip, neg, pos)
            const_fire = beta >= theta          # γ==0 ⇒ y = β
            row = np.where(gamma == 0,
                           np.where(const_fire, THR_ALWAYS, THR_NEVER), row)
            thr[t] = row.astype(np.int64)
    # γ<0 reverses threshold order across t; restore ascending order.
    thr = np.sort(thr, axis=0)
    thr = np.clip(thr, THR_ALWAYS, THR_NEVER)
    return thr.astype(np.int32), flip


def _layer_input_scale(config: NetworkConfig, is_first: bool) -> float:
    if is_first:
        return 1.0 / 128.0 if config.input_kind == "int8" else 1.0
    return 1.0 if config.abits == 1 else 1.0 / 3.0


def _weight_scale(wbits: int) -> float:
    return 1.0 if wbits == 1 else 1.0 / 3.0


def compile_network(config: NetworkConfig, params, batch_stats,
                    meta: Optional[Dict] = None) -> CompiledNetwork:
    """Fold + quantize + pack a trained QuantNet into engine parameters.

    `params`/`batch_stats`: parameter trees of the training model (naming
    contract `quant_{i}` / `bn_{i}`).
    """
    params = _to_plain_dict(params)
    batch_stats = _to_plain_dict(batch_stats)
    specs = config.layers
    compute_idx = [i for i, s in enumerate(specs)
                   if not isinstance(s, PoolSpec)]
    last_compute = compute_idx[-1]
    first_compute = compute_idx[0]
    bits = config.bits

    layers: List[Dict[str, np.ndarray]] = []
    out_scale = out_bias = None
    for i, spec in enumerate(specs):
        if isinstance(spec, PoolSpec):
            layers.append({})
            continue
        w = np.asarray(params[f"quant_{i}"]["kernel"])
        bn_p = params[f"bn_{i}"]
        bn_s = batch_stats[f"bn_{i}"]
        gamma = np.asarray(bn_p["scale"])
        beta = np.asarray(bn_p["bias"])
        mean = np.asarray(bn_s["mean"])
        var = np.asarray(bn_s["var"])

        wl = _quantize_weights_np(w, config.wbits)      # integer levels
        # Static overflow guard: int32 accumulators must
        # hold |acc| <= K * max|w| * max|a| with margin for the sentinel
        # thresholds (|thr| <= 2^30).
        k_len = int(np.prod(w.shape[:-1]))
        max_a = 127 if (config.input_kind == "int8"
                        and f"quant_{i}" == f"quant_{first_compute}") else 3
        if k_len * 3 * max_a >= (1 << 30):
            raise OverflowError(
                f"layer {i}: accumulator range {k_len * 3 * max_a} risks "
                "int32 overflow against sentinel thresholds")
        if wl.ndim == 4:
            kh, kw, cin, cout = wl.shape
            wmat = wl.reshape(kh * kw * cin, cout)      # (ki,kj,c) order
        else:
            wmat = wl

        s = _weight_scale(config.wbits) * _layer_input_scale(
            config, i == first_compute)

        if i == last_compute:
            sigma = np.sqrt(var.astype(np.float64) + BN_EPS)
            out_scale = (gamma.astype(np.float64) * s / sigma).astype(np.float32)
            out_bias = (beta.astype(np.float64)
                        - gamma.astype(np.float64) * mean.astype(np.float64)
                        / sigma).astype(np.float32)
            thr, flip = None, np.zeros(wmat.shape[1], dtype=bool)
        else:
            thr, flip = _fold_bn_to_thresholds(
                gamma, beta, mean, var, s,
                _activation_boundaries(config.abits))
        wmat = np.where(flip[None, :], -wmat, wmat).astype(np.int8)

        entry: Dict[str, np.ndarray] = {}
        if i == first_compute and config.input_kind == "int8":
            entry["w_int8"] = wmat                       # int8 first conv
        elif bits == 1:
            entry["w_packed"] = packing.np_pack_bits(wmat, axis=0)
        else:
            codes = ((wmat.astype(np.int16) + 3) // 2).astype(np.int8)
            entry["w_packed"] = packing.np_pack_codes2(codes, axis=0)
        if thr is not None:
            entry["thr"] = thr
        layers.append(entry)

    return CompiledNetwork(config=config, layers=layers,
                           out_scale=out_scale, out_bias=out_bias,
                           meta=dict(meta or {}))


def _to_plain_dict(tree):
    """FrozenDict / nested dict → plain nested dict of numpy arrays."""
    if hasattr(tree, "unfreeze"):
        tree = tree.unfreeze()
    if isinstance(tree, dict):
        return {k: _to_plain_dict(v) for k, v in tree.items()}
    return np.asarray(tree)
