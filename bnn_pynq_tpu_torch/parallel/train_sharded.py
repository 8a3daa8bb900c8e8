"""Sharded (dp × tp) training on torch.distributed.

Port of `bnn_pynq_tpu/parallel/train_sharded.py`. JAX annotates the
parameter shardings and lets GSPMD partition the float training graph;
here every rank holds its shard of the model as an `nn.Module` and runs
the same program (SPMD), with the collectives explicit and counted
(`parallel/comm.py`):

- the quantized kernels whose output width divides by the 'model' axis,
  and the BatchNorm vectors of the same layers, hold N/m output columns
  (`_param_spec`, JAX's rule); every other parameter is whole on every
  rank (the classes-wide last layer where 10 % m != 0);
- in front of a column-parallel layer `copy_to_model` (its backward sums
  the input's gradient over 'model'); after its BatchNorm and quantizer
  the codes are gathered over 'model' on the channel dim by
  `gather_model` (its backward takes this rank's slice), after a
  following maxpool where there is one (the pool is channelwise);
- the batch is split over 'data', and BatchNorm's E[x] and E[x²] are
  averaged over 'data' by `mean_over_data` before the variance is formed,
  so that the statistics are the global batch's, as GSPMD keeps them; the
  running statistics follow from the global values;
- after the backward every gradient is averaged over 'data' in one flat
  `psum` (no DDP: its buckets and hooks would hide the collectives),
  then the port's `Adam.update` with the clip of the quantized kernels.

Per step, then: per sharded layer one `gather_model` forward, one
`copy_to_model` backward (none for the first layer, whose input needs no
gradient) and one `mean_over_data` each way; per BatchNorm of a whole
layer one `mean_over_data` each way; two `psum` (gradients, loss).

The step is the trainer's `TrainStep` on the sharded body: on a card under
NCCL its warm-up steps run eagerly (creating the communicators), then one
step is captured, the backward's collectives on autograd's device thread
included, and replayed, as JAX jits its step; the epoch replays it over
the stacked batches and fetches the losses once, as JAX scans it. The
captured step reads its learning rate and bias corrections from Adam's
table on the device as the eager one does; the table of
`init_sharded`'s `Adam(total_steps=1)` grows by doubling as the run goes
on, each growth a new capture on every rank at the same step. Under
gloo, or on the CPU, it runs the eager step.

Specs are tuples of mesh axis names or None per dimension, as
`parallel/tp.py::param_specs` writes them: `(None, None, None, "model")`
is JAX's `P(None, None, None, "model")`, `()` its `P()`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bnn_pynq_tpu_torch.models.config import ConvSpec, NetworkConfig, PoolSpec
from bnn_pynq_tpu_torch.parallel import comm
from bnn_pynq_tpu_torch.parallel.spmd import execution_of
from bnn_pynq_tpu_torch.train.model import (BatchNorm, QuantNet, full_fp32)
from bnn_pynq_tpu_torch.train.quant import quantize_activations
from bnn_pynq_tpu_torch.train.trainer import (Adam, TrainStep, _flatten,
                                              _unflatten, squared_hinge_loss)

Spec = Tuple[Optional[str], ...]


def _param_spec(path, shape, model_size: int) -> Spec:
    """JAX's sharding rule: quantized kernels on their last (output) dim
    over 'model'; BatchNorm vectors over 'model'; anything whose output
    width does not divide by the model axis replicated."""
    name = str(path[-1])
    owner = str(path[0]) if path else ""
    if owner.startswith("quant_") and name == "kernel" \
            and shape[-1] % model_size == 0:
        return (None,) * (len(shape) - 1) + ("model",)
    if owner.startswith("bn_") and len(shape) == 1 \
            and shape[0] % model_size == 0:
        return ("model",)
    return ()


def _stats_spec(path, shape, model_size: int) -> Spec:
    """batch_stats mirror the BatchNorm vectors."""
    return ("model",) if len(shape) == 1 and shape[0] % model_size == 0 \
        else ()


def make_param_shardings(params, mesh):
    """The spec of every leaf of a flax-layout params tree, in its
    layout. Reads only `mesh.shape`."""
    m = mesh.shape["model"]
    return _unflatten({k: _param_spec(k, np.shape(v), m)
                       for k, v in _flatten(params).items()})


def _shard_tree(tree, spec_of, mesh) -> dict:
    """This rank's float32 numpy blocks of a flax-layout tree."""
    m = mesh.shape["model"]
    out = {}
    for path, v in _flatten(tree).items():
        a = np.asarray(v, np.float32)
        if "model" in spec_of(path, a.shape, m):
            w = a.shape[-1] // m
            j = mesh.coords[1]
            a = a[..., j * w:(j + 1) * w]
        out[path] = np.ascontiguousarray(a)
    return _unflatten(out)


def _on_device(tree, device) -> dict:
    return _unflatten({k: torch.from_numpy(v).to(device)
                       for k, v in _flatten(tree).items()})


def shard_train_state(params, batch_stats, opt_state, mesh):
    """Carry a training state onto this rank: its local slices, as float32
    tensors on `mesh.device`, in flax's layout.

    params / batch_stats: flax-layout trees of arrays (JAX's, or the
    port's `QuantNet.variables()`). opt_state: None, or the port's Adam
    moments {"count": int, "mu": tree, "nu": tree} in the params' layout,
    sliced as their parameters (JAX replicates them; Adam is elementwise,
    so the update is the same). Returns (params, batch_stats, opt_state).
    """
    p = _shard_tree(params, _param_spec, mesh)
    bs = _shard_tree(batch_stats, _stats_spec, mesh)
    if opt_state is not None:
        opt_state = dict(opt_state, **{
            k: _on_device(_shard_tree(opt_state[k], _param_spec, mesh),
                          mesh.device) for k in ("mu", "nu")})
    return _on_device(p, mesh.device), _on_device(bs, mesh.device), \
        opt_state


class _DataBatchNorm(BatchNorm):
    """BatchNorm whose batch moments are the global batch's: averaged over
    the 'data' group (one `mean_over_data` of E[x] and E[x²] stacked)."""

    def __init__(self, features: int, group):
        super().__init__(features)
        self.group = group

    def batch_moments(self, x):
        both = comm.mean_over_data(torch.stack(super().batch_moments(x)),
                                   self.group)
        return both[0], both[1]


class ShardedQuantNet(QuantNet):
    """This rank's shard of a `QuantNet` on a ('data', 'model') mesh.

    Built from the full flax-layout `params` / `batch_stats` (every rank
    passes the same), of which it keeps its blocks (`shard_train_state`'s
    rule) on `mesh.device`. `sharded` holds the indices of the
    column-parallel layers. The modules are the port's `QuantConv`,
    `QuantDense` and `BatchNorm` (with its moments averaged over 'data');
    `variables()` gives this rank's blocks, `gather_variables` the whole
    model. Deterministic quantizers only, as JAX's sharded path."""

    def __init__(self, config: NetworkConfig, mesh, params, batch_stats):
        super().__init__(config)
        self.mesh = mesh
        specs = make_param_shardings(params, mesh)
        self.sharded = frozenset(
            i for i in range(len(config.layers))
            if "model" in specs.get(f"quant_{i}", {}).get("kernel", ()))
        p = _shard_tree(params, _param_spec, mesh)
        bs = _shard_tree(batch_stats, _stats_spec, mesh)
        for name, leaves in p.items():
            if name.startswith("quant_"):
                self.layers[name].kernel = torch.nn.Parameter(
                    torch.empty(leaves["kernel"].shape))
            else:
                self.layers[name] = _DataBatchNorm(leaves["scale"].shape[0],
                                                   mesh.data_group)
        self.load_variables(p, bs)
        self.to(mesh.device)

    def forward(self, x, train: bool = False):
        cfg = self.config
        group = self.mesh.model_group
        if cfg.input_kind == "bipolar":
            x = x.reshape(x.shape[0], -1)
        elif x.ndim == 4:
            x = x.permute(0, 3, 1, 2)                    # NHWC → NCHW
        pending = False          # this rank holds only its channels
        for i, spec in enumerate(cfg.layers):
            if isinstance(spec, PoolSpec):
                x = F.max_pool2d(x, spec.window, spec.window)
                continue
            if pending:
                x = comm.gather_model(x, group, 1)
            if not isinstance(spec, ConvSpec) and x.ndim > 2:
                x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            if i in self.sharded:
                x = comm.copy_to_model(x, group)
            x = self.layers[f"quant_{i}"](x)
            x = self.layers[f"bn_{i}"](x, train)
            if i != self.last_compute:
                x = quantize_activations(x, cfg.abits)
            pending = i in self.sharded
        if pending:
            x = comm.gather_model(x, group, 1)
        return x


def gather_variables(model: ShardedQuantNet, mesh) -> dict:
    """The whole model's {"params", "batch_stats"} in flax's layout, as
    float32 numpy on every rank (the column-parallel layers' leaves
    all-gathered over 'model'): what `compile_network`,
    `save_checkpoint` and `InferenceEngine.from_training` take."""
    out = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        _, layer, leaf = key.split(".")
        if int(layer.split("_")[1]) in model.sharded:
            t = comm.all_gather(t, mesh.model_group, axis=-1)
        kind = "batch_stats" if leaf in ("mean", "var") else "params"
        out[kind].setdefault(layer, {})[leaf] = t.cpu().numpy().copy()
    return out


def _rows(t, mesh) -> torch.Tensor:
    """This rank's 'data' rows of a global batch: a view, on the batch's
    device (a numpy batch as a CPU tensor on its memory)."""
    d, i = mesh.shape["data"], mesh.coords[0]
    if t.shape[0] % d:
        raise ValueError(f"batch {t.shape[0]} does not split over "
                         f"'data' = {d}")
    n = t.shape[0] // d
    return torch.as_tensor(t[i * n:(i + 1) * n])


def make_sharded_train_step(config: NetworkConfig, mesh,
                            model: ShardedQuantNet, tx: Adam) -> TrainStep:
    """step(x, y) → the global batch's loss (a device scalar, equal on
    every rank); updates this rank's shard in place. Every rank passes the
    global batch (numpy or tensors; the batch must divide by 'data') and
    trains on its rows. The port's `make_train_step(config, model, tx)`
    with the mesh; JAX's takes no model because flax's is stateless.

    A `TrainStep` on this body: this rank's rows through the forward (its
    BatchNorm moments averaged over 'data'), `autograd.grad`, the
    gradients averaged over 'data' in one flat `psum`, the loss likewise;
    then `tx.apply`. On a card under NCCL it is captured after the
    warm-up, collectives and all, and replayed; the rows are copied into
    its fixed buffers; under gloo it stays eager (parallel/spmd.py's
    `execution`)."""
    group = mesh.data_group
    d = mesh.shape["data"]

    def loss_and_grads(x, y):
        with full_fp32():
            loss = squared_hinge_loss(model(x, train=True), y,
                                      config.num_classes)
            grads = torch.autograd.grad(loss, tx.params)
        flat = comm.psum(torch.cat([g.reshape(-1) for g in grads]),
                         group) / d
        return comm.psum(loss.detach(), group) / d, [
            f.view_as(g) for f, g in zip(
                flat.split([g.numel() for g in grads]), grads)]

    return TrainStep(config, model, tx, loss_and_grads,
                     lambda x, y: (_rows(x, mesh), _rows(y, mesh)),
                     capture=execution_of(mesh) == "graphs")


def make_sharded_epoch_fn(config: NetworkConfig, mesh,
                          model: ShardedQuantNet, tx: Adam):
    """run(xs, ys) → the step losses (numpy): the sharded step over
    pre-batched xs [steps, batch, ...], ys [steps, batch] in order, no
    shuffle, each loss written into one device tensor fetched once (JAX's
    `lax.scan`). On a card it replays the captured step (`run.step`)."""
    step = make_sharded_train_step(config, mesh, model, tx)

    def run(xs, ys):
        losses = torch.empty(len(xs), dtype=torch.float32,
                             device=mesh.device)
        for i, (x, y) in enumerate(zip(xs, ys)):
            losses[i] = step.run(x, y, check=i == 0)
        return losses.cpu().numpy()

    run.step = step
    return run


def init_sharded(config: NetworkConfig, mesh, *, lr: float = 1e-3,
                 seed: int = 0, sample_input=None):
    """(model, tx): this rank's `ShardedQuantNet` of the `QuantNet` every
    rank builds from `torch.Generator().manual_seed(seed)`, and the
    counterpart of `optax.adam(lr)`: the port's `Adam` at the constant
    float32 rate `lr` with no Glorot scale (JAX's sharded path has none,
    and `Adam` would read the fans from the local kernel shapes, wrong on
    a shard); the clip of the quantized kernels stays in `update`. JAX
    returns (model, params, batch_stats, opt_state, tx); here the
    parameters, statistics and moments are the module's and `tx`'s own
    state. `sample_input` is accepted for JAX's signature: flax infers
    shapes from it, the module needs none."""
    del sample_input
    full = QuantNet(config,
                    generator=torch.Generator().manual_seed(seed)).variables()
    model = ShardedQuantNet(config, mesh, full["params"],
                            full["batch_stats"])
    tx = Adam(model, total_steps=1, lr_start=lr, lr_end=lr,
              glorot_lr_scale=False)
    return model, tx
