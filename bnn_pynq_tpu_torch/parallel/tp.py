"""Tensor-parallel inference over a ('data', 'model') mesh: the packed
engine and the decoded-integer engine.

Port of `bnn_pynq_tpu/parallel/tp.py`. `TPInferenceEngine`,
Megatron-style column parallelism on the packed kernels:
- every packed weight matrix [Kw, N] and threshold table [nthr, N] is
  sharded on N over 'model' (replicated over 'data');
- each rank computes its output channels with the SAME kernels as one
  card (`ops/conv.py::conv2d_packed` and `ops/matmul.py::packed_matmul`,
  csrc/packed_matmul.cu; an 8-bit first conv is `xla_layer`'s cuBLASLt
  int8 GEMM, `ops/int_dot.py::int_matmul`, where JAX runs XLA's int8
  dot), then the 1- or 2-bit codes are all-gathered over 'model' so that
  the next layer sees its whole contraction axis;
- the batch is split over 'data';
- the last (classes-wide) layer is replicated: its N is 10 or 43, and the
  gathered input is already on every rank.

JAX wraps that layer loop in `shard_map` because GSPMD cannot partition
a `pallas_call`; here each rank runs it on its own shards and the
collectives are explicit calls (parallel/comm.py).

`make_gspmd_engine`, JAX's decoded-integer route under sharding:
`forward_xla`'s layers (`models/network.py::xla_layer`, library calls
only) on `decode_params`' arrays, each array cut on its last axis over
'model' where the layer is not the last and the axis divides, the rest
replicated. JAX annotates those shardings and GSPMD inserts the
collectives; here they are explicit: an all-gather of the codes after
every column-sharded layer, and the logits gathered over 'data'.

Every rank returns the logits of the whole batch, gathered over 'data',
as JAX's calls return them. The engines' serving surface, and the
programs they run in place of JAX's jitted calls (a CUDA graph a shape
under NCCL), are runtime/engine.py's `Engine` and `Programs`, with
parallel/spmd.py's data split and leader.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bnn_pynq_tpu_torch.compiler.artifacts import CompiledNetwork
from bnn_pynq_tpu_torch.models.config import NetworkConfig
from bnn_pynq_tpu_torch.models.network import (decode_params, make_plan,
                                               prepare_input, xla_layer)
from bnn_pynq_tpu_torch.models.params import params_from_numpy
from bnn_pynq_tpu_torch.ops.conv import (conv2d_packed, maxpool2d,
                                         pack_along_last)
from bnn_pynq_tpu_torch.ops.int_dot import k_contiguous
from bnn_pynq_tpu_torch.ops.matmul import ROUTES, packed_matmul_padded
from bnn_pynq_tpu_torch.ops.packing import words_to_tensor
from bnn_pynq_tpu_torch.parallel import comm
from bnn_pynq_tpu_torch.parallel.spmd import SPMDEngine, execution_of
from bnn_pynq_tpu_torch.runtime.engine import (DEFAULT_BATCH_BUCKETS,
                                               Programs, pad_rows, to_device)

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
    `models/params.py::params_from_numpy` keeps them), `w_int8` int8
    stored K-contiguous (`int_matmul`'s operand, copied once here) and
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
        if "w_int8" in q:
            q["w_int8"] = k_contiguous(q["w_int8"])
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
                act = xla_layer(config, lp, p, act)
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


def _cut(arr: torch.Tensor, lp, mesh) -> Tuple[torch.Tensor, bool]:
    """JAX's GSPMD rule for one decoded array: this rank's N/m slice of
    its last axis when the layer is not the last and the axis divides by
    m = mesh.shape['model'], else the whole array (replicated). A cut
    keeps the array's layout (a K-contiguous weight stays K-contiguous)
    and holds only the slice. Returns (array, cut)."""
    m, j = mesh.shape["model"], mesh.coords[1]
    n = arr.shape[-1]
    if lp.last or m == 1 or n % m:
        return arr, False
    return arr[..., j * (n // m):(j + 1) * (n // m)].clone(), True


def make_gspmd_engine(compiled: CompiledNetwork, mesh):
    """Tensor- and data-parallel inference on the decoded-integer route;
    returns `logits(x_prepared) -> np.ndarray`, called on every rank.

    As JAX's: `decode_params` of the compiled layers (through
    `params_from_numpy`, as the engine's 'xla' route loads them), every
    decoded array (`w_int8` [K, N], `w_hwio` [kh, kw, C, N], `thr`
    [nthr, N]) column-sharded on its last axis over 'model' where the
    layer is not the last and N divides by the axis, else replicated;
    `out_scale` and `out_bias` replicated; the batch split over 'data'.
    Each rank runs `forward_xla`'s layers (`xla_layer`, conv_mode
    'patches', JAX's default: windows and cuBLASLt's int8 GEMM, no
    hand-written kernel) on its shards, all-gathers the codes over
    'model' after every column-sharded layer (the collective GSPMD puts
    in JAX's program), applies scale and bias in float32 and gathers the
    logits over 'data'.

    As JAX jits it, `logits` runs one program per padded shape (its
    `programs`, by this rank's input shape; parallel/spmd.py's
    `execution`, kept on `logits.execution`); `logits.forward(x_local)`
    is the eager forward the programs run, `logits.params` this rank's
    decoded shards, layer by layer."""
    config, device = compiled.config, mesh.device
    plan = make_plan(config)
    mg, dg = mesh.model_group, mesh.data_group
    layers, scale, bias = params_from_numpy(
        config, compiled.layers, compiled.out_scale, compiled.out_bias,
        device)
    params, gathered = [], []
    for lp, p in zip(plan, decode_params(config, layers)):
        cuts = {name: _cut(arr, lp, mesh) for name, arr in p.items()}
        params.append({name: arr for name, (arr, _) in cuts.items()})
        gathered.append(any(cut for _, cut in cuts.values()))
    del layers

    def local_forward(x):
        act = prepare_input(config, x)
        for lp, p, cut in zip(plan, params, gathered):
            act = xla_layer(config, lp, p, act)
            if cut:
                act = comm.all_gather(act, mg, axis=act.ndim - 1)
        logits = act.to(torch.float32) * scale + bias
        return comm.gather_batch(logits, dg)

    execution, dd = execution_of(mesh), mesh.shape["data"]
    programs = Programs(
        execution, torch.cuda.Stream(device) if execution == "graphs"
        else None, lambda shape: local_forward,
        lambda shape: f"make_gspmd_engine on mesh {dict(mesh.shape)} (rank "
                      f"{dist.get_rank()}), bucket {shape[0] * dd} (local "
                      f"input {shape} int8), variant logits", comm.counts)

    def logits(x_prepared):
        x = np.asarray(x_prepared, dtype=np.int8)
        b = x.shape[0]
        x = pad_rows(x, -(-b // dd) * dd)
        rows = x.shape[0] // dd
        xl = to_device(x[mesh.coords[0] * rows:][:rows], device)
        return programs.run(tuple(xl.shape), xl).cpu().numpy()[:b]

    logits.programs = programs
    logits.execution = execution
    logits.forward = local_forward
    logits.params = params
    return logits


class TPInferenceEngine(SPMDEngine):
    """Tensor-parallel engine on the packed kernels (the logits/classify
    surface of runtime.InferenceEngine for prepared inputs, and the
    serving hooks: bucketed launch without fetch, device argmax, `fetch`
    and the topology-checked hot swap of runtime/engine.py's `Engine`;
    parallel/spmd.py). No packed-words path, as JAX's."""

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

    def _load(self, compiled):
        params = shard_params(compiled.layers, self.mesh, compiled.config)
        scale, bias = (torch.from_numpy(np.asarray(v, np.float32))
                       .to(self.device)
                       for v in (compiled.out_scale, compiled.out_bias))
        return params, scale, bias

    def _forward(self, params, x_local):
        return self._fn(*params, x_local)

    def launch_prepared(self, xd, *, argmax: bool = False,
                        words: bool = False):
        """Launch on a padded device batch without fetching."""
        if words:
            raise ValueError("TPInferenceEngine has no packed-words path")
        return super().launch_prepared(xd, argmax=argmax)
