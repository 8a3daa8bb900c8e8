"""Inference graph: config + decoded params → forward pass on tensors.

Port of `bnn_pynq_tpu/models/network.py`, five forwards:
- `forward_mega` / `mega_stages` (← the JAX `mega` route): the network as
  a list of kernel stages and plain glue, with the same stage names as the
  JAX route wherever the stage exists. For CNV: chain0-1 → pool2 →
  chain3-4 → pool5 → block6 → mlp_tail, i.e. `conv_chain` (twice),
  `dense_block` and `fused_mlp_forward_padded`. The JAX route's `im2col0`
  stage is gone there: the conv kernel reads the raw image itself. A
  strided conv keeps JAX's layout: `im2col{i}` (`sliding_window` with the
  stride), then `chain{i}-{j}` on `conv_chain(input_patches=True)`.
  `forward_mega` runs each chain that a 2×2 pool follows on an even map
  as one stage, `chain{i}-{j}+pool{k}` (`conv_chain(pool=True)`: the last
  conv's epilogue pools), where `mega_stages` by default keeps JAX's
  stages one by one.
- `forward` (← `forward(impl="pallas")`, the packed routes `vpu`, `mxu`,
  `mxu_rm`): every binary or 2-bit conv and dense layer packs its input
  codes into words and runs `packed_matmul` (the CUDA kernel
  `csrc/packed_matmul.cu`); CNV's first, 8-bit conv is `xla_layer`'s:
  windows and cuBLASLt's int8 GEMM (`ops/int_dot.py::int_matmul`), where
  JAX runs XLA's int8 dot; pools run on codes. W1A1 bipolar nets also take
  host-packed words (the `binarizeAndPack` contract).
- `forward_direct` (← `forward_direct`, the `direct` route): every binary
  or 2-bit conv runs `conv2d_direct` (the CUDA kernel
  `csrc/conv_direct.cu`), on codes, with no im2col; CNV's first, 8-bit
  conv and the dense layers are `xla_layer`'s, cuBLASLt's int8 GEMM, as
  JAX leaves them to XLA's int8 dot.
- `forward_xla` (← `forward_xla`, the `xla` and `xlaconv` routes) on
  `decode_params`' layers: JAX's decoded-integer route, every dot and conv
  a library call (`ops/int_dot.py`: cuBLASLt's int8 GEMM, cuDNN's float64
  conv), the MultiThresholds in PyTorch; no hand-written kernel.
- `forward_ref` (← `forward_xla(conv_mode="patches")`): per layer a
  sliding window, an exact int matmul and a MultiThreshold. The port's
  independent reference.

MobileNet-v1 W4A4 and ResNet-50 v1.5 W1A2 (`config.mega_only`:
depthwise, padded or residual layers, average or overlapping max pools,
unsigned codes) run on `mega` and `forward_ref` alone; the packed, direct
and decoded-integer routes raise NotImplementedError for them
(`refuse_mega_only`). Their `mega` stages come a layer at a time
(`_layer_stages`), on unsigned codes, which are their own levels:
`im2col0` (the padded, strided image patches) → `chain0-0` (`conv_chain`
on them); MobileNet's `dw{i}` (`depthwise_conv`) and `pw{i}`
(`dense_block` on the B·H·W rows of codes); ResNet's `pool1` (the 3×3
stride-2 max pool, glue over codes) and one stage a bottleneck block,
`res{stage}.{block}`, which keeps its input for the shortcut: the 1×1
conv on `dense_block`, the 3×3 conv on `conv_chain` over the map padded
with code 0 (at stride 2 `dense_block` on the rows of its padded
patches, whose 2,304-4,608 lanes `conv_chain`'s staged tile cannot
hold), and the block's last 1×1 conv on `dense_residual`, whose
accumulator takes the shortcut before the thresholds; then `gap{i}` (the
int32 window sum and its MultiThreshold) → `mlp_tail`
(`fused_mlp_forward_padded`: the classifier with scale and bias).

`layers` is the first element of `params_from_numpy`'s result: per config
layer `{}` (pool) or `{"w": WeightMatrix, "w_packed": int32 words [Kw, N]
(packed layers only), "w_int8": int8 [K, N] K-contiguous, "thr": int32
[nthr, N]}`. `forward_ref` is the
plain float64 product's (`ops/ref.py::int_matmul_ref` on the card); no
route of the kernels runtime calls it.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, List, Tuple

import numpy as np
import torch

from bnn_pynq_tpu_torch.models.config import (AvgPoolSpec, BottleneckSpec,
                                              ConvSpec, DenseSpec,
                                              DepthwiseSpec, MaxPoolSpec,
                                              NetworkConfig, PoolSpec)
from bnn_pynq_tpu_torch.ops.conv import (conv2d_packed, conv_weight_matrix,
                                         maxpool2d, pack_along_last,
                                         sliding_window)
from bnn_pynq_tpu_torch.ops.conv_direct import conv2d_direct
from bnn_pynq_tpu_torch.ops.conv_stack import (conv_chain, dense_block,
                                               dense_residual,
                                               dense_residual_plain)
from bnn_pynq_tpu_torch.ops.depthwise import depthwise_acc, depthwise_conv
from bnn_pynq_tpu_torch.ops.fused_mlp import fused_mlp_forward_padded
from bnn_pynq_tpu_torch.ops.int_dot import int_conv2d, int_matmul
from bnn_pynq_tpu_torch.ops.matmul import packed_matmul_padded
from bnn_pynq_tpu_torch.ops.packing import np_pack_bits, np_pack_codes2
from bnn_pynq_tpu_torch.ops.ref import int_matmul_ref
from bnn_pynq_tpu_torch.ops.thresholds import (codes_to_values,
                                               multithreshold)


@dataclass(frozen=True)
class LayerPlan:
    kind: str                     # 'dense' | 'conv' | 'conv_int8' | 'pool'
                                  # | 'dwconv' | 'avgpool' | 'maxpool'
                                  # | 'bottleneck'
    k: int = 0                    # contraction length (dense/conv; K² for
                                  # a depthwise conv; a bottleneck block's
                                  # input channels)
    n: int = 0                    # output features/channels
    kernel: int = 0
    stride: int = 1
    window: int = 0
    last: bool = False            # last compute layer → int32 logits
    pad: int = 0                  # zero padding on each side
    mid: int = 0                  # a bottleneck block's inner width
    projection: bool = False      # ... whose shortcut is a 1×1 conv


def _out_size(n: int, kernel: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - kernel) // stride + 1


def make_plan(config: NetworkConfig) -> Tuple[LayerPlan, ...]:
    """Derive the static per-layer execution plan from a config."""
    h, w, c = config.input_shape
    plans = []
    specs = config.layers
    last_compute = max(i for i, s in enumerate(specs)
                       if not isinstance(s, (PoolSpec, AvgPoolSpec,
                                             MaxPoolSpec)))
    flat = False
    for i, spec in enumerate(specs):
        if isinstance(spec, ConvSpec):
            kind = "conv_int8" if (i == 0 and config.input_kind == "int8") \
                else "conv"
            k = spec.kernel * spec.kernel * c
            plans.append(LayerPlan(kind=kind, k=k, n=spec.out_ch,
                                   kernel=spec.kernel, stride=spec.stride,
                                   last=(i == last_compute), pad=spec.pad))
            h = _out_size(h, spec.kernel, spec.stride, spec.pad)
            w = _out_size(w, spec.kernel, spec.stride, spec.pad)
            c = spec.out_ch
        elif isinstance(spec, DepthwiseSpec):
            plans.append(LayerPlan(kind="dwconv", k=spec.kernel ** 2, n=c,
                                   kernel=spec.kernel, stride=spec.stride,
                                   last=(i == last_compute), pad=spec.pad))
            h = _out_size(h, spec.kernel, spec.stride, spec.pad)
            w = _out_size(w, spec.kernel, spec.stride, spec.pad)
        elif isinstance(spec, PoolSpec):
            plans.append(LayerPlan(kind="pool", window=spec.window))
            h //= spec.window
            w //= spec.window
        elif isinstance(spec, AvgPoolSpec):
            plans.append(LayerPlan(kind="avgpool", n=c, window=spec.window))
            h //= spec.window
            w //= spec.window
        elif isinstance(spec, MaxPoolSpec):
            plans.append(LayerPlan(kind="maxpool", n=c, kernel=spec.kernel,
                                   stride=spec.stride, pad=spec.pad))
            h = _out_size(h, spec.kernel, spec.stride, spec.pad)
            w = _out_size(w, spec.kernel, spec.stride, spec.pad)
        elif isinstance(spec, BottleneckSpec):
            plans.append(LayerPlan(kind="bottleneck", k=c, n=spec.out,
                                   kernel=3, stride=spec.stride,
                                   last=(i == last_compute), pad=1,
                                   mid=spec.mid,
                                   projection=spec.projection))
            h = _out_size(h, 3, spec.stride, 1)
            w = _out_size(w, 3, spec.stride, 1)
            c = spec.out
        elif isinstance(spec, DenseSpec):
            if not flat:
                k = h * w * c
                flat = True
            else:
                k = c
            plans.append(LayerPlan(kind="dense", k=k, n=spec.out_features,
                                   last=(i == last_compute)))
            c = spec.out_features
            h = w = 1
        else:
            raise TypeError(f"unknown layer spec {spec!r}")
    return tuple(plans)


def init_random_params(config: NetworkConfig, seed: int = 0):
    """Random packed parameters with plausible thresholds, for tests and
    kernel timings before trained artifacts exist.

    Port of `bnn_pynq_tpu/models/network.py::init_random_params`: the same
    per-layer dicts (`w_int8` or `w_packed` uint32 words, `thr` int32 on
    all but the last layer) as numpy arrays, drawn from
    `np.random.default_rng(seed)` in the same order, so one (config, seed)
    gives equal arrays in both packages. `params_from_numpy` takes them.
    """
    refuse_mega_only(config, "init_random_params (such a net's artifact "
                     "comes from its generator in portbench/configs/)")
    rng = np.random.default_rng(seed)
    bits = config.bits
    params = []
    for lp in make_plan(config):
        if lp.kind == "pool":
            params.append({})
            continue
        if lp.kind == "conv_int8":
            wmat = rng.choice([-1, 1], size=(lp.k, lp.n)).astype(np.int8)
            if config.wbits == 2:
                wmat = rng.choice([-3, -1, 1, 3],
                                  size=(lp.k, lp.n)).astype(np.int8)
            entry = {"w_int8": wmat}
            scale = lp.k * 128
        else:
            if bits == 1:
                wvals = rng.choice([-1, 1], size=(lp.k, lp.n)).astype(np.int8)
                packed = np_pack_bits(wvals, axis=0)
            else:
                if config.wbits == 1:
                    wcodes = rng.choice([1, 2],
                                        size=(lp.k, lp.n)).astype(np.int8)
                else:
                    wcodes = rng.integers(0, 4,
                                          size=(lp.k, lp.n)).astype(np.int8)
                packed = np_pack_codes2(wcodes, axis=0)
            entry = {"w_packed": packed}
            scale = lp.k * (1 if bits == 1 else 9)
        if not lp.last:
            entry["thr"] = np.sort(
                rng.integers(-scale // 4, scale // 4,
                             size=(config.nthr, lp.n)),
                axis=0).astype(np.int32)
        params.append(entry)
    return params


def prepare_input(config: NetworkConfig, x: torch.Tensor) -> torch.Tensor:
    """Engine input → first activation: bipolar → codes ({0,1} for W1A1,
    {1,2} = levels ±1 otherwise), int8 images stay int8 levels."""
    if config.input_kind == "bipolar":
        pos = x.reshape(x.shape[0], -1) > 0
        if config.bits == 1:
            return pos.to(torch.int8)
        return (pos.to(torch.int8) + 1).to(torch.int8)
    return x.to(torch.int8)


# Below this many output positions a conv leaves the chain kernel and runs
# as im2col + dense_block on B·OH·OW rows (the JAX route's threshold; kept
# so both routes group layers into the same stages).
_MEGA_SMALL_HW = 100

Stage = Tuple[str, Callable[[torch.Tensor], torch.Tensor]]


def mega_stages(config: NetworkConfig, layers, out_scale: torch.Tensor,
                out_bias: torch.Tensor, *,
                fuse_pools: bool = False) -> List[Stage]:
    """The kernel route as (name, fn) stages; folding the fns over
    `prepare_input(config, x)` gives float32 logits [B, num_classes].
    fuse_pools: a conv chain whose output map is even and that the plan
    follows with a 2×2 pool pools in its kernel's epilogue, one stage
    `chain{i}-{j}+pool{k}` in place of `chain{i}-{j}` and `pool{k}` (the
    same codes: `forward_mega` runs so)."""
    if config.mega_only:
        return _layer_stages(config, layers, out_scale, out_bias)
    plan = make_plan(config)
    abits = config.abits
    if config.input_kind == "bipolar":
        h, w = 1, 1
        levels = False
    else:
        h, w, _ = config.input_shape
        levels = True

    stages: List[Stage] = []
    idx = 0
    n = len(plan)
    # -- phase 1: large-spatial conv chains + pools ------------------------
    while idx < n and plan[idx].kind != "dense":
        lp = plan[idx]
        if lp.kind == "pool":
            stages.append((f"pool{idx}", partial(maxpool2d,
                                                 window=lp.window)))
            h //= lp.window
            w //= lp.window
            idx += 1
            continue
        oh = (h - lp.kernel) // lp.stride + 1
        if oh * oh < _MEGA_SMALL_HW and lp.stride == 1:
            break  # small-spatial tail (phase 2)
        ow = (w - lp.kernel) // lp.stride + 1
        group = [idx]
        j = idx + 1
        while (j < n and plan[j].kind == "conv" and plan[j].stride == 1
               and plan[j].kernel == lp.kernel and not plan[j].last
               and min(oh, ow) - len(group) * (lp.kernel - 1) > 0):
            group.append(j)
            j += 1
        if plan[group[0]].last:
            raise NotImplementedError(
                "mega route expects a dense (or small-conv) final stage")
        # a strided conv's patches are prebuilt, as in JAX (which also
        # prebuilds the image conv's and those of channels that are no
        # multiple of 32; the conv kernel reads those in place)
        prebuild = lp.stride != 1
        if prebuild:
            stages.append((f"im2col{idx}", partial(
                sliding_window, kh=lp.kernel, kw=lp.kernel,
                stride=lp.stride)))
        shrink = (len(group) - 1) * (lp.kernel - 1)
        h, w = oh - shrink, ow - shrink
        name = f"chain{group[0]}-{group[-1]}"
        pool = (fuse_pools and j < n and plan[j].kind == "pool"
                and plan[j].window == 2 and h % 2 == 0 and w % 2 == 0)
        if pool:
            name += f"+pool{j}"
            h, w = h // 2, w // 2
            j += 1
        stages.append((name, partial(
            conv_chain, weights=[layers[g]["w"] for g in group],
            thresholds=[layers[g]["thr"] for g in group],
            kernel=lp.kernel, abits=abits, input_patches=prebuild,
            input_levels=levels, pool=pool)))
        levels = False
        idx = j

    # -- phase 2: small-spatial convs + dense tail -------------------------
    mlp_ws, mlp_ts = [], []
    while idx < n:
        lp = plan[idx]
        p = layers[idx]
        if lp.kind == "pool":
            stages.append((f"pool{idx}", partial(maxpool2d,
                                                 window=lp.window)))
            h //= lp.window
            w //= lp.window
            idx += 1
            continue
        if lp.kind in ("conv", "conv_int8"):
            oh = (h - lp.kernel) // lp.stride + 1
            ow = (w - lp.kernel) // lp.stride + 1
            if lp.last:
                raise NotImplementedError(
                    "mega route expects a dense (or 1×1-output conv) "
                    "final stage")
            if oh == 1 and ow == 1 and not levels:
                # the kernel covers the map: conv ≡ dense on the flattened
                # rows ((ki,kj,c) order equals a row-major reshape here),
                # folded into the MLP tail
                mlp_ws.append(p["w"])
                mlp_ts.append(p["thr"])
                idx += 1
                continue
            stages.append((f"block{idx}", partial(
                _conv_block, w=p["w"], thr=p["thr"], kernel=lp.kernel,
                stride=lp.stride, abits=abits, levels=levels)))
            h, w = oh, ow
            levels = False
            idx += 1
            continue
        mlp_ws.append(p["w"])
        if not lp.last:
            mlp_ts.append(p["thr"])
        idx += 1

    if not mlp_ws:
        raise NotImplementedError("mega route needs a dense final stage")
    stages.append(("mlp_tail", partial(
        _mlp_tail, weights=mlp_ws, thresholds=mlp_ts, out_scale=out_scale,
        out_bias=out_bias, abits=abits)))
    return stages


def _layer_stages(config: NetworkConfig, layers, out_scale, out_bias):
    """MobileNet's and ResNet's stages, a layer at a time: an image conv
    on its prebuilt padded, strided patches, then depthwise and pointwise
    convs (MobileNet), a max pool and bottleneck blocks (ResNet), a
    thresholded average pool and the classifier, on unsigned codes (their
    own levels, which the pool sums and the kernels read as levels)."""
    abits = config.abits
    if not config.codes_are_levels:
        raise NotImplementedError(
            f"mega route: {config.name}'s layers run a layer at a time, on "
            "unsigned codes only")
    stages: List[Stage] = []
    plan = make_plan(config)
    stage, block = 1, 0
    for idx, (lp, p) in enumerate(zip(plan, layers)):
        if lp.kind == "conv_int8" and not lp.last:
            stages.append((f"im2col{idx}", partial(
                _padded_patches, kernel=lp.kernel, stride=lp.stride,
                pad=lp.pad)))
            stages.append((f"chain{idx}-{idx}", partial(
                conv_chain, weights=[p["w"]], thresholds=[p["thr"]],
                kernel=lp.kernel, input_patches=True, input_levels=True,
                abits=abits)))
        elif lp.kind == "dwconv" and not lp.last:
            stages.append((f"dw{idx}", partial(
                depthwise_conv, w=p["w"], thr=p["thr"], stride=lp.stride,
                abits=abits)))
        elif lp.kind == "conv" and lp.kernel == 1 and lp.stride == 1 and \
                not lp.pad and not lp.last:
            stages.append((f"pw{idx}", partial(
                _pointwise, w=p["w"], thr=p["thr"], abits=abits)))
        elif lp.kind == "maxpool":
            stages.append((f"pool{idx}", partial(
                maxpool_padded, kernel=lp.kernel, stride=lp.stride,
                pad=lp.pad)))
        elif lp.kind == "bottleneck" and not lp.last:
            stage, block = (stage + 1, 1) if lp.projection else \
                (stage, block + 1)
            stages.append((f"res{stage}.{block}", partial(
                _bottleneck, p=p, stride=lp.stride,
                projection=lp.projection, abits=abits)))
        elif lp.kind == "avgpool":
            stages.append((f"gap{idx}", partial(
                _avgpool_threshold, window=lp.window, thr=p["thr"])))
        elif lp.kind == "dense" and lp.last and idx == len(plan) - 1:
            stages.append(("mlp_tail", partial(
                _mlp_tail, weights=[p["w"]], thresholds=[],
                out_scale=out_scale, out_bias=out_bias, abits=abits,
                input_levels=True)))
        else:
            raise NotImplementedError(
                f"mega route: no stage for layer {idx} ({lp}) of "
                f"{config.name}")
    return stages


def _padded_patches(x, *, kernel, stride, pad):
    """Zero-padded image → the conv's patches [B, OH, OW, K²·C]."""
    x = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    return sliding_window(x, kernel, kernel, stride)


def _pointwise(a, *, w, thr, abits):
    """A 1×1 conv as `dense_block` on the B·H·W rows of unsigned codes
    (their own levels)."""
    b, h, wd, c = a.shape
    rows = dense_block(a.reshape(b * h * wd, c), [w], [thr], abits=abits,
                       input_levels=True)
    return rows.reshape(b, h, wd, w.kn.shape[1])


def maxpool_padded(a, *, kernel, stride, pad):
    """The max pool over kernel×kernel windows at `stride` of codes
    [B, H, W, C] padded with code 0 (codes are never below 0, so the
    padding never wins): the largest of the kernel² strided views, plain
    glue over int8 → [B, OH, OW, C]."""
    b, h, w, c = a.shape
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (w + 2 * pad - kernel) // stride + 1
    x = torch.nn.functional.pad(a, (0, 0, pad, pad, pad, pad))
    out = None
    for i in range(kernel):
        for j in range(kernel):
            v = x[:, i:i + stride * (oh - 1) + 1:stride,
                  j:j + stride * (ow - 1) + 1:stride]
            out = v.clone() if out is None else torch.maximum(out, v)
    return out


def _bottleneck(x, *, p, stride, projection, abits):
    """One bottleneck block on codes x [B, H, W, C]: the 1×1 conv and its
    MultiThreshold (`dense_block`), the 3×3 conv over the map padded with
    code 0 (`conv_chain`; at stride 2 `dense_block` on the rows of the
    padded map's patches: `conv_chain` stages a tile's whole patch rows in
    shared memory, which at K = 9·mid = 2,304-4,608 leaves no room, where
    `dense_block` streams K), then `dense_residual`: the last 1×1 conv
    with the shortcut (x's codes, or the projection of x at the stride) in
    its accumulator, thresholded → codes [B, OH, OW, out]."""
    a = _pointwise(x, w=p["wa"], thr=p["thr_a"], abits=abits)
    if stride == 1:
        b = conv_chain(torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1)),
                       [p["wb"]], [p["thr_b"]], kernel=3, input_levels=True,
                       abits=abits)
    else:
        b = _pointwise(_padded_patches(a, kernel=3, stride=stride, pad=1),
                       w=p["wb"], thr=p["thr_b"], abits=abits)
    n, oh, ow, mid = b.shape
    y = dense_residual(b.reshape(n * oh * ow, mid), x, p["wc"], p["r"],
                       p["thr"], stride=stride, projection=projection)
    return y.reshape(n, oh, ow, -1)


def _avgpool_threshold(a, *, window, thr):
    """The thresholded average pool over the whole map: the int32 sum of
    each channel's codes (unsigned: their own levels), then a MultiThreshold
    of its thresholds (which carry the divisor), as one compare and one
    sum on the device → int8 codes [B, C]."""
    if a.shape[1] != window or a.shape[2] != window:
        raise NotImplementedError(f"average pool {window}×{window} over a "
                                  f"{a.shape[1]}×{a.shape[2]} map")
    s = a.sum(dim=(1, 2), dtype=torch.int32)
    return (s[:, None, :] >= thr).sum(dim=1, dtype=torch.int8)


def _conv_block(a, *, w, thr, kernel, stride, abits, levels):
    patches = sliding_window(a, kernel, kernel, stride)
    b, oh, ow, k = patches.shape
    rows = dense_block(patches.reshape(b * oh * ow, k), [w], [thr],
                       abits=abits, input_levels=levels)
    return rows.reshape(b, oh, ow, w.kn.shape[1])


def _mlp_tail(a, *, weights, thresholds, out_scale, out_bias, abits,
              input_levels=False):
    return fused_mlp_forward_padded(a.reshape(a.shape[0], -1), weights,
                                    thresholds, out_scale, out_bias,
                                    abits=abits, input_levels=input_levels)


def forward_mega(config: NetworkConfig, layers, x: torch.Tensor,
                 out_scale: torch.Tensor,
                 out_bias: torch.Tensor) -> torch.Tensor:
    """Kernel-route forward: float32 logits [B, num_classes]."""
    act = prepare_input(config, x)
    for _, fn in mega_stages(config, layers, out_scale, out_bias,
                             fuse_pools=True):
        act = fn(act)
    return act


def forward(config: NetworkConfig, layers, x: torch.Tensor, *,
            route: str = "mxu") -> torch.Tensor:
    """Packed-route forward: int32 logits [B, num_classes] (scale/bias not
    applied, as in JAX `forward`).

    x: bipolar nets: int8 values [B, ...] (binarized at > 0), or, for
       W1A1 only, int32 host-packed words [B, packed_len] (bit = pixel on);
       int8 nets: int8 levels [B, H, W, C].
    route: 'vpu' (W1A1 only), 'mxu' or 'mxu_rm' (see ops/matmul.py).
    """
    refuse_mega_only(config, f"the packed route {route!r}")
    plan = make_plan(config)
    bits = config.bits
    packed_input = config.input_kind == "bipolar" and x.dtype == torch.int32
    if packed_input:
        if bits != 1:
            raise ValueError("packed input requires a packed route and a "
                             "W1A1 network")
        act = x.reshape(x.shape[0], -1)
    else:
        act = prepare_input(config, x)

    for lp, p in zip(plan, layers):
        thr = None if lp.last else p.get("thr")
        if lp.kind == "pool":
            act = maxpool2d(act, lp.window)
        elif lp.kind == "conv_int8":
            act = xla_layer(config, lp, p, act)
        elif lp.kind == "conv":
            act = conv2d_packed(act, p["w_packed"], thr, kernel=lp.kernel,
                                stride=lp.stride, bits=bits, route=route)
        else:
            if act.ndim > 2:
                act = act.reshape(act.shape[0], -1)
            if packed_input:
                a_words, packed_input = act, False
            else:
                a_words = pack_along_last(act, bits)
            act = packed_matmul_padded(a_words, p["w_packed"], thr, k=lp.k,
                                       bits=bits, route=route)
    return act


def make_forward_fn(config: NetworkConfig, *, route: str = "mxu"):
    """Return `fn(layers, x) -> int32 logits`, the packed forward."""
    return partial(forward, config, route=route)


def forward_ref(config: NetworkConfig, layers,
                x: torch.Tensor) -> torch.Tensor:
    """Reference forward: int32 logits [B, num_classes] (scale/bias not
    applied, as in `forward_xla`)."""
    act = prepare_input(config, x)
    for lp, p in zip(make_plan(config), layers):
        act = _ref_layer(config, lp, p, act)
    return act


def _ref_layer(config: NetworkConfig, lp: LayerPlan, p,
               act: torch.Tensor) -> torch.Tensor:
    """One layer of `forward_ref`: pool, or sliding window + exact int
    matmul + MultiThreshold (int32 accumulators on the last layer); a
    depthwise conv's sum of shifted products; an average pool's window
    sum; a bottleneck block's three products and its shortcut."""
    lv = dict(abits=config.abits, unsigned=config.unsigned)
    if lp.kind == "pool":
        return maxpool2d(act, lp.window)
    if lp.kind == "maxpool":
        return maxpool_padded(act, kernel=lp.kernel, stride=lp.stride,
                              pad=lp.pad)
    if lp.kind == "bottleneck":
        return _bottleneck_ref(lp, p, act, **lv)
    if lp.kind == "avgpool":
        vals = codes_to_values(act, **lv).to(torch.int32)
        acc = vals.reshape(act.shape[0], -1, act.shape[-1]).sum(
            dim=1, dtype=torch.int32)
        return multithreshold(acc, p["thr"])
    if lp.kind == "conv_int8":
        vals = act        # raw int8 image, already levels
    else:
        if act.ndim > 2 and lp.kind == "dense":
            act = act.reshape(act.shape[0], -1)
        vals = codes_to_values(act, **lv)
    if lp.kind == "dwconv":
        acc = depthwise_acc(vals, p["w"].kn, stride=lp.stride)
        return acc if lp.last else multithreshold(acc, p["thr"])
    if lp.pad:
        vals = torch.nn.functional.pad(vals, (0, 0) + (lp.pad,) * 4)
    if lp.kind in ("conv", "conv_int8"):
        patches = sliding_window(vals, lp.kernel, lp.kernel, lp.stride)
        b, oh, ow, k = patches.shape
        acc = int_matmul_ref(patches.reshape(b * oh * ow, k),
                             p["w"].kn).reshape(b, oh, ow, lp.n)
    else:
        acc = int_matmul_ref(vals, p["w"].kn)
    return acc if lp.last else multithreshold(acc, p["thr"])


def _bottleneck_ref(lp: LayerPlan, p, x: torch.Tensor, *, abits,
                    unsigned) -> torch.Tensor:
    """`forward_ref`'s bottleneck block: each conv a sliding window (the
    3×3 over the map padded with level 0) and an exact int matmul, each
    MultiThreshold, and the shortcut as `dense_residual_plain` adds it."""
    def conv(a, w, kernel, stride, pad):
        vals = codes_to_values(a, abits, unsigned)
        if pad:
            vals = torch.nn.functional.pad(vals, (0, 0) + (pad,) * 4)
        patches = sliding_window(vals, kernel, kernel, stride)
        b, oh, ow, k = patches.shape
        return int_matmul_ref(patches.reshape(b * oh * ow, k),
                              w.kn).reshape(b, oh, ow, -1)
    a = multithreshold(conv(x, p["wa"], 1, 1, 0), p["thr_a"])
    b = multithreshold(conv(a, p["wb"], 3, lp.stride, 1), p["thr_b"])
    n, oh, ow, mid = b.shape
    y = dense_residual_plain(b.reshape(-1, mid), x, p["wc"], p["r"],
                             p["thr"], stride=lp.stride,
                             projection=lp.projection)
    return y.reshape(n, oh, ow, -1)


def decode_params(config: NetworkConfig, layers):
    """The port's layers → the JAX package's decoded form
    (`bnn_pynq_tpu/models/network.py::decode_params`), array for array:
    per layer `{"w_int8": int8 [K, N]}` (a dense layer or an 8-bit first
    conv) or `{"w_hwio": int8 [kh, kw, C, N]}` (any other conv), plus
    "thr" where the layer has thresholds; `{}` for a pool. The weights are
    views of the layers' K-contiguous `w_int8` (`params_from_numpy`), the
    layout `int_matmul` takes without a copy; `w_hwio` is then
    channels-last for `int_conv2d` too (O outermost), and
    `conv_weight_matrix` of it a view."""
    refuse_mega_only(config, "decode_params (the decoded-integer routes)")
    out = []
    for lp, p in zip(make_plan(config), layers):
        if lp.kind == "pool":
            out.append({})
            continue
        kn = p["w_int8"]
        if lp.kind == "conv":
            c = lp.k // (lp.kernel * lp.kernel)
            q = {"w_hwio": kn.reshape(lp.kernel, lp.kernel, c, lp.n)}
        else:
            q = {"w_int8": kn}
        if "thr" in p:
            q["thr"] = p["thr"]
        out.append(q)
    return out


CONV_MODES = ("patches", "native", "s2d")


def forward_xla(config: NetworkConfig, decoded, x: torch.Tensor, *,
                conv_mode: str = "patches",
                force_thresholds: bool = False) -> torch.Tensor:
    """Decoded-integer forward: int32 logits [B, num_classes] (scale and
    bias not applied, as in JAX), JAX's layer loop on `decode_params`'
    layers. Dense layers: `int_matmul` on the levels. Convs by conv_mode:
    'patches': sliding window, then `int_matmul`; 'native': `int_conv2d`
    (cuDNN, no patches); 's2d': JAX's space-to-depth form, bit for bit
    'patches' (its docstring), whose phase layout only suited the TPU's
    dot shapes: computed as 'patches'.

    force_thresholds: JAX's profiling aid, kept for its signature. As in
    JAX's 'patches' and 'native' forms, a last layer still gives its
    int32 accumulators (it has no thresholds), so it changes nothing."""
    if conv_mode not in CONV_MODES:
        raise ValueError(f"unknown conv_mode {conv_mode!r}; one of "
                         f"{CONV_MODES}")
    refuse_mega_only(config, "the decoded-integer routes")
    act = prepare_input(config, x)
    for lp, p in zip(make_plan(config), decoded):
        act = xla_layer(config, lp, p, act, conv_mode=conv_mode,
                        force_thresholds=force_thresholds)
    return act


def xla_layer(config: NetworkConfig, lp: LayerPlan, p, act: torch.Tensor, *,
              conv_mode: str = "patches",
              force_thresholds: bool = False) -> torch.Tensor:
    """One layer of `forward_xla` on its decoded parameters `p`; a layer's
    weights may be a column shard (N/m of its N), whose output is N/m
    wide."""
    thr = p.get("thr") if force_thresholds else \
        (None if lp.last else p.get("thr"))
    if lp.kind == "pool":
        return maxpool2d(act, lp.window)
    if lp.kind == "conv_int8":
        vals = act        # raw int8 image, already levels
    else:
        if act.ndim > 2 and lp.kind == "dense":
            act = act.reshape(act.shape[0], -1)
        vals = codes_to_values(act, config.abits)
    if lp.kind == "dense":
        acc = int_matmul(vals, p["w_int8"])
    elif conv_mode == "native":
        w_hwio = p["w_hwio"] if "w_hwio" in p else p["w_int8"].reshape(
            lp.kernel, lp.kernel, lp.k // (lp.kernel * lp.kernel), -1)
        acc = int_conv2d(vals, w_hwio, lp.stride)
    else:
        w = conv_weight_matrix(p["w_hwio"]) if "w_hwio" in p \
            else p["w_int8"]
        patches = sliding_window(vals, lp.kernel, lp.kernel, lp.stride)
        b, oh, ow, k = patches.shape
        acc = int_matmul(patches.reshape(b * oh * ow, k),
                         w).reshape(b, oh, ow, -1)
    return acc if lp.last else multithreshold(acc, thr)


def forward_direct(config: NetworkConfig, layers,
                   x: torch.Tensor) -> torch.Tensor:
    """Direct-route forward: int32 logits [B, num_classes] (scale/bias not
    applied, as in JAX `forward_direct`). Every 'conv' layer runs
    `conv2d_direct` on codes (int32 out on a last layer); pools, the 8-bit
    first conv and dense layers are `xla_layer`'s: `int_matmul` on the
    K-contiguous `w_int8`, where JAX's `forward_direct` runs XLA's int8
    dot."""
    refuse_mega_only(config, "the direct route")
    act = prepare_input(config, x)
    for lp, p in zip(make_plan(config), layers):
        if lp.kind == "conv":
            act = conv2d_direct(act, p["w"], None if lp.last else p["thr"],
                                kernel=lp.kernel, abits=config.abits,
                                stride=lp.stride)
        else:
            act = xla_layer(config, lp, p, act)
    return act


def refuse_mega_only(config: NetworkConfig, what: str) -> None:
    """The one check of what runs `config.mega_only` layers: `what` (a
    route or a function of one) does not, so such a `config` raises."""
    if config.mega_only:
        raise NotImplementedError(
            f"{config.name}: {what} runs no depthwise, padded or residual "
            "layer, average or overlapping max pool, or unsigned code; use "
            "route='mega' or runtime='ref'")


def input_shape(config: NetworkConfig, batch: int) -> Tuple[int, ...]:
    """Shape of a prepared engine input batch."""
    if config.input_kind == "bipolar":
        return (batch, int(np.prod(config.input_shape)))
    return (batch,) + tuple(config.input_shape)
