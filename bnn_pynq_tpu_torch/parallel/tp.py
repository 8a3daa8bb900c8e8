"""Tensor-parallel packed inference over a ('data', 'model') mesh.

Port of `bnn_pynq_tpu/parallel/tp.py`: Megatron-style column parallelism.
- every packed weight matrix [Kw, N] and threshold table [nthr, N] is
  sharded on N over 'model' (replicated over 'data');
- each rank computes its output channels with the SAME kernels as one
  card (`ops/conv.py::conv2d_packed` and `ops/matmul.py::packed_matmul`,
  csrc/packed_matmul.cu; an 8-bit first conv is the exact
  `int_matmul_ref`, as the port's `models/network.py::forward` runs it),
  then the 1- or 2-bit codes are all-gathered over 'model' so that the next
  layer sees its whole contraction axis;
- the batch is split over 'data';
- the last (classes-wide) layer is replicated: its N is 10 or 43, and the
  gathered input is already on every rank.

JAX wraps the layer loop in `shard_map` because GSPMD cannot partition a
`pallas_call`; here each rank runs it on its own shards and the
collectives are explicit calls (parallel/comm.py). Every rank returns the
logits of the whole batch, gathered over 'data', as JAX's call returns
them. The engines' serving surface is parallel/spmd.py's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bnn_pynq_tpu_torch.compiler.artifacts import CompiledNetwork
from bnn_pynq_tpu_torch.models.config import NetworkConfig
from bnn_pynq_tpu_torch.models.network import make_plan, prepare_input
from bnn_pynq_tpu_torch.models.params import weight_matrix
from bnn_pynq_tpu_torch.ops.conv import (conv2d_packed, maxpool2d,
                                         pack_along_last, sliding_window)
from bnn_pynq_tpu_torch.ops.conv_direct import conv2d_direct
from bnn_pynq_tpu_torch.ops.matmul import ROUTES, packed_matmul_padded
from bnn_pynq_tpu_torch.ops.packing import words_to_tensor
from bnn_pynq_tpu_torch.ops.ref import int_matmul_ref
from bnn_pynq_tpu_torch.ops.thresholds import multithreshold
from bnn_pynq_tpu_torch.parallel import comm
from bnn_pynq_tpu_torch.parallel.overlap import dense, first_conv, \
    layer_levels
from bnn_pynq_tpu_torch.parallel.spmd import (DEFAULT_BATCH_BUCKETS,
                                              SPMDEngine)

Spec = Tuple[Optional[str], ...]
MODEL_COLS: Spec = (None, "model")
REPLICATED: Spec = (None, None)


def param_specs(config: NetworkConfig) -> List[Dict[str, Spec]]:
    """Per layer, each parameter's spec: a tuple of mesh axis names or
    None per dimension, as JAX's `P(...)` (`(None, "model")`: columns over
    'model')."""
    specs = []
    for lp in make_plan(config):
        if lp.kind == "pool":
            specs.append({})
            continue
        key = "w_int8" if lp.kind == "conv_int8" else "w_packed"
        if lp.last:
            # classes-wide final layer: replicated
            specs.append({key: REPLICATED})
        else:
            specs.append({key: MODEL_COLS, "thr": MODEL_COLS})
    return specs


def _local(arr: np.ndarray, spec: Spec, mesh) -> np.ndarray:
    """This rank's block of `arr` under `spec`."""
    if spec != MODEL_COLS:
        return arr
    m, j = mesh.shape["model"], mesh.coords[1]
    n = arr.shape[-1]
    if n % m:
        raise ValueError(f"width {n} does not split over 'model' = {m}")
    return arr[..., j * (n // m):(j + 1) * (n // m)]


def shard_params(params, mesh, config: NetworkConfig):
    """This rank's shards of a CompiledNetwork's layers on its device:
    `w_packed` uint32 words as their int32 bit pattern (as
    `models/params.py::params_from_numpy` keeps them), `w_int8` int8 and
    `thr` int32, each cut as `param_specs` says."""
    specs = param_specs(config)
    out = []
    for i, layer in enumerate(params):
        q = {}
        for k, v in layer.items():
            a = np.ascontiguousarray(_local(np.asarray(v), specs[i][k],
                                            mesh))
            t = words_to_tensor(a) if a.dtype == np.uint32 \
                else torch.from_numpy(a)
            q[k] = t.to(mesh.device)
        out.append(q)
    return out


def make_tp_forward(config: NetworkConfig, mesh, *, route: str = "mxu"):
    """fn(params, out_scale, out_bias, x_local) → float32 logits of the
    whole batch, on every rank. params are `shard_params`'s, x_local this
    rank's rows of the batch. route: 'mxu' (default), 'mxu_rm', or 'vpu'
    (W1A1)."""
    plan = make_plan(config)
    bits = config.bits
    mg, dg = mesh.model_group, mesh.data_group

    def fn(params, out_scale, out_bias, x):
        act = prepare_input(config, x)
        for lp, p in zip(plan, params):
            thr = None if lp.last else p.get("thr")
            if lp.kind == "pool":
                act = maxpool2d(act, lp.window)
                continue
            if lp.kind == "conv_int8":
                patches = sliding_window(act, lp.kernel, lp.kernel,
                                         lp.stride)
                b, oh, ow, k = patches.shape
                acc = int_matmul_ref(patches.reshape(b * oh * ow, k),
                                     p["w_int8"]).reshape(b, oh, ow, -1)
                act = acc if lp.last else multithreshold(acc, thr)
            elif lp.kind == "conv":
                act = conv2d_packed(act, p["w_packed"], thr,
                                    kernel=lp.kernel, stride=lp.stride,
                                    bits=bits, route=route)
            else:
                if act.ndim > 2:
                    act = act.reshape(act.shape[0], -1)
                act = packed_matmul_padded(pack_along_last(act, bits),
                                           p["w_packed"], thr, k=lp.k,
                                           bits=bits, route=route)
            if not lp.last:
                # gather this layer's output channels from the model axis
                act = comm.all_gather(act, mg, axis=act.ndim - 1)
        logits = act.to(torch.float32) * out_scale + out_bias
        return comm.gather_batch(logits, dg)

    return fn


def make_gspmd_engine(compiled: CompiledNetwork, mesh):
    """Tensor- and data-parallel inference on decoded integer levels;
    returns `logits(x_prepared) -> np.ndarray`, called on every rank.

    JAX's counterpart annotates shardings and lets GSPMD insert the
    collectives. Torch has no GSPMD: this keeps JAX's name and its rule (a
    layer whose N divides by 'model' is column-sharded, the last layer and
    the others are replicated; the batch is split over 'data') and makes
    the collectives explicit: an all-gather of the codes after every
    sharded layer, and the logits gathered over 'data'. Local compute is
    OverlapTPEngine's blocking arm: `conv_chain` for the first conv on the
    raw image, `conv2d_direct` for the others, `int_matmul_ref` for dense
    layers."""
    config, device = compiled.config, mesh.device
    plan = make_plan(config)
    m, my = mesh.shape["model"], mesh.coords[1]
    mg, dg = mesh.model_group, mesh.data_group
    abits = config.abits
    layers = []
    for lp, p in zip(plan, compiled.layers):
        if lp.kind == "pool":
            layers.append(None)
            continue
        kn = layer_levels(config, lp, p)
        sharded = not lp.last and lp.n % m == 0
        cols = slice(my * (lp.n // m), (my + 1) * (lp.n // m)) if sharded \
            else slice(None)
        w = torch.from_numpy(np.ascontiguousarray(kn[:, cols])).to(device)
        if lp.kind != "dense":
            w = weight_matrix(w)
        thr = None if lp.last else torch.from_numpy(np.ascontiguousarray(
            np.asarray(p["thr"], np.int32)[:, cols])).to(device)
        layers.append((w, thr, sharded))
    scale = torch.from_numpy(np.asarray(compiled.out_scale,
                                        np.float32)).to(device)
    bias = torch.from_numpy(np.asarray(compiled.out_bias,
                                       np.float32)).to(device)

    def local_forward(x):
        levels = config.input_kind == "int8"
        act = x if levels else prepare_input(config, x)
        for lp, layer in zip(plan, layers):
            if lp.kind == "pool":
                act = maxpool2d(act, lp.window)
                continue
            w, thr, sharded = layer
            if lp.kind == "dense":
                act = dense(act.reshape(act.shape[0], -1), w, thr, abits,
                            levels=levels)
            elif levels:
                act = first_conv(act, w, thr, lp, abits)
            else:
                act = conv2d_direct(act, w, thr, kernel=lp.kernel,
                                    abits=abits, stride=lp.stride)
            levels = False
            if sharded:
                act = comm.all_gather(act, mg, axis=act.ndim - 1)
        logits = act.to(torch.float32) * scale + bias
        return comm.gather_batch(logits, dg)

    def logits(x_prepared):
        x = np.asarray(x_prepared, dtype=np.int8)
        b = x.shape[0]
        dd = mesh.shape["data"]
        pad = (-b) % dd
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        rows = x.shape[0] // dd
        lo = mesh.coords[0] * rows
        xl = torch.from_numpy(np.ascontiguousarray(x[lo:lo + rows]))
        return local_forward(xl.to(device)).cpu().numpy()[:b]

    return logits


class TPInferenceEngine(SPMDEngine):
    """Tensor-parallel engine on the packed kernels (the logits/classify
    surface of runtime.InferenceEngine for prepared inputs, and the
    serving hooks: bucketed launch without fetch, device argmax, `fetch`
    and the topology-checked hot swap; parallel/spmd.py)."""

    def __init__(self, compiled: CompiledNetwork, mesh, route: str = "mxu",
                 batch_buckets=DEFAULT_BATCH_BUCKETS):
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}; one of {ROUTES}")
        if route == "vpu" and compiled.config.bits != 1:
            raise ValueError("route='vpu' (XNOR popcount) requires a W1A1 "
                             "network")
        self.route = route
        super().__init__(compiled, mesh, batch_buckets)
        self._fn = make_tp_forward(self.config, mesh, route=route)

    def _shard(self, compiled):
        params = shard_params(compiled.layers, self.mesh, compiled.config)
        scale, bias = (torch.from_numpy(np.asarray(v, np.float32))
                       .to(self.device)
                       for v in (compiled.out_scale, compiled.out_bias))
        return params, scale, bias

    def _forward(self, state, x_local):
        return self._fn(*state, x_local)

    def launch_prepared(self, xd, *, argmax: bool = False,
                        words: bool = False):
        """Launch on a padded device batch without fetching."""
        if words:
            raise ValueError("TPInferenceEngine has no packed-words path")
        return super().launch_prepared(xd, argmax=argmax)
