"""The training loop: squared hinge loss, Adam, exponential learning-rate
decay, the Glorot learning-rate scale and a hard clip of the quantized
kernels to [-1, 1] after each update, best-validation checkpoints (.npz).

Port of `bnn_pynq_tpu/train/trainer.py` (optax, `lax.scan`). One step is
the reference's, operation for operation: optax's Adam (b1 0.9, b2 0.999,
eps 1e-8, bias-corrected moments), then × −lr(t) with
lr(t) = lr_start·(lr_end/lr_start)^(t/total_steps) (`optax.exponential_
decay`; the first update uses lr_start), then × each quantized kernel's
Glorot scale 1/sqrt(1.5/(fan_in + fan_out)), then added to the parameter,
then the quantized kernels clipped.

Device: `train(..., device="cuda")` by default; without CUDA it raises
(pass device="cpu"). The dataset stays on the device, each epoch is
shuffled there by `randperm` from an explicit generator, and the losses
are fetched once an epoch, so no step waits for the host.

Captured step, the port's form of the reference's jitted step and its
`lax.scan` epoch: on a card, `make_train_step` runs its first
WARMUP_STEPS steps eagerly on its own stream (real steps of the run),
then captures one step (forward, gradients, Adam, clip) in a CUDA graph
on fixed input, label and loss buffers and replays it: a step costs two
copies and one graph launch. Adam reads its learning rate and bias
corrections from a float32 table on the device, indexed by a step
counter the step itself advances, so the captured step is the eager
one; a run that outlasts the table grows it to twice the steps taken
and captures the step again on it. The graph holds the addresses of the parameters, statistics and
moments: they are updated in place and never rebound (`load_variables`
copies); a replay raises if one was. A capture that fails raises; on the
CPU the same step object runs the eager body.

Precision: float32 throughout, with TF32 off for the trainer's
convolutions and products (`model.full_fp32`, around every forward and
backward pass here). cuDNN's TF32 default would round the 2-bit levels
±1/3 and every gradient to 10 mantissa bits; at full float32 the forward
of a W1 network is integer-exact as on the CPU, a step on the card stays
within float32 summation order of the same step on the CPU, and the
float model's argmax agrees with the integer engine's.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bnn_pynq_tpu_torch.models.config import NetworkConfig
from bnn_pynq_tpu_torch.ops._build import gc_paused
from bnn_pynq_tpu_torch.train import data as data_mod
from bnn_pynq_tpu_torch.train.model import QuantNet, full_fp32

# optax.adam's defaults, which the reference's trainer uses.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# Reference training recipes (BinaryNet conventions; the published BNN
# schedules). Keys match NetworkConfig.dataset.
TRAINING_PRESETS = {
    "mnist": dict(epochs=1000, batch_size=100, lr_start=3e-3, lr_end=3e-7),
    "cifar10": dict(epochs=500, batch_size=50, lr_start=1e-3, lr_end=1e-6),
    "svhn": dict(epochs=200, batch_size=50, lr_start=1e-3, lr_end=1e-6),
    "gtsrb": dict(epochs=200, batch_size=50, lr_start=1e-3, lr_end=1e-6),
}


def preset_for(config: NetworkConfig) -> dict:
    return dict(TRAINING_PRESETS.get(config.dataset,
                                     dict(epochs=100, batch_size=100,
                                          lr_start=1e-3, lr_end=1e-6)))


@dataclass
class TrainResult:
    """Best-validation `params` / `batch_stats` (flax layout, numpy), the
    per-epoch `history` ({"epoch", "loss", "val_acc", "losses": the
    epoch's step losses, "seconds": the epoch's training time on the host
    clock, ending in the loss fetch}), and `model`, the QuantNet as the
    last epoch left it, on its device."""
    params: Any
    batch_stats: Any
    history: list = field(default_factory=list)
    best_val_acc: float = 0.0
    model: Optional[QuantNet] = None


def squared_hinge_loss(logits, labels, num_classes: int):
    """Multi-class squared hinge on ±1 targets: a mean over B × classes."""
    t = 2.0 * F.one_hot(labels.long(), num_classes).to(logits.dtype) - 1.0
    return torch.mean(torch.square(torch.clamp_min(1.0 - t * logits, 0.0)))


def _is_quant_kernel(path) -> bool:
    return any(str(p).startswith("quant_") for p in path) and \
        str(path[-1]) == "kernel"


def _flatten(tree, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[tuple, Any]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _glorot_scale_tree(params):
    """Per-kernel LR multiplier 1/sqrt(1.5/(fan_in+fan_out)) (BinaryNet's
    W_LR_scale='Glorot' convention); 1.0 for every other leaf."""
    scales = {}
    for path, leaf in _flatten(params).items():
        if _is_quant_kernel(path):
            if leaf.ndim == 2:
                fan_in, fan_out = leaf.shape
            else:
                kh, kw, cin, cout = leaf.shape
                fan_in, fan_out = kh * kw * cin, kh * kw * cout
            scales[path] = float(1.0 / np.sqrt(1.5 / (fan_in + fan_out)))
        else:
            scales[path] = 1.0
    return _unflatten(scales)


def _path(name: str) -> tuple:
    """'layers.quant_0.kernel' → ('quant_0', 'kernel')."""
    return tuple(name.split(".")[1:])


class Adam:
    """optax.chain(adam(exponential_decay(lr_start, total_steps,
    lr_end/lr_start)), per-leaf scale) for a QuantNet's parameters, then
    the clip of the quantized kernels: updates in place. The scalars
    (learning rate, bias corrections) are computed on the host in float32
    as optax computes them, once for every step, into a table on the
    parameters' device (`table`: rows of −lr, 1 − b1^t, 1 − b2^t by step);
    a step reads its row through the device counter `step`, so no step
    waits for the host and a captured step replays the schedule. `count`
    is the same counter on the host."""

    def __init__(self, model: QuantNet, total_steps: int, lr_start: float,
                 lr_end: float, glorot_lr_scale: bool = True):
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        paths = [_path(n) for n, _ in named]
        if glorot_lr_scale:
            flat = _flatten(_glorot_scale_tree(_unflatten(
                dict(zip(paths, self.params)))))
            self.scales = [flat[p] for p in paths]
        else:
            self.scales = [1.0] * len(paths)
        self.clipped = [p for path, p in zip(paths, self.params)
                        if _is_quant_kernel(path)]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.total_steps = total_steps
        self.lr_start, self.lr_end = lr_start, lr_end
        device = self.params[0].device
        self.step = torch.zeros(1, dtype=torch.int64, device=device)
        self.table = torch.empty((0, 3), dtype=torch.float32, device=device)
        self.reserve(total_steps)

    def learning_rate(self, count: int) -> float:
        """optax.exponential_decay in float32; lr_start at count 0."""
        if count <= 0:
            return float(np.float32(self.lr_start))
        p = np.float32(count) / np.float32(self.total_steps)
        rate = np.float32(self.lr_end / self.lr_start)
        return float(np.float32(self.lr_start) * np.power(rate, p))

    def _row(self, count: int):
        """(−lr, bias correction 1, bias correction 2) of the update that
        takes the count from `count` to `count + 1`."""
        t = np.float32(count + 1)
        return (-self.learning_rate(count),
                float(np.float32(1) - np.float32(ADAM_B1) ** t),
                float(np.float32(1) - np.float32(ADAM_B2) ** t))

    def reserve(self, steps: int) -> None:
        """Make the table cover the first `steps` updates (a new table:
        never after a step that reads it was captured)."""
        have = self.table.shape[0]
        if steps > have:
            rows = torch.tensor([self._row(c) for c in range(have, steps)],
                                dtype=torch.float32)
            self.table = torch.cat([self.table, rows.to(self.table.device)])

    @torch.no_grad()
    def apply(self, grads) -> None:
        """One update on the device from the table row of `step`, which it
        advances; reads nothing on the host (a graph can capture it).
        `count` is the caller's to advance."""
        b1, b2 = ADAM_B1, ADAM_B2
        row = self.table.index_select(0, self.step)[0]
        neg_lr, bc1, bc2 = row[0], row[1], row[2]
        self.step.add_(1)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, ADAM_EPS)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_mul_(upd, self.scales)
        torch._foreach_add_(self.params, upd)
        for p in self.clipped:
            p.clamp_(-1.0, 1.0)

    def update(self, grads) -> None:
        """One update (eager): the table grown if the run goes past
        `total_steps`, then `apply`."""
        self.reserve(self.count + 1)
        self.apply(grads)
        self.count += 1


# eager steps a captured step runs (on its stream) before it captures
WARMUP_STEPS = 2


def _given(x, y):
    return x, y


class TrainStep:
    """step(x, y) → the batch's loss (a device scalar); updates the model's
    parameters and running statistics in place. On a card the first
    WARMUP_STEPS calls run the eager step on the step's own stream, the
    next captures it (cuDNN's benchmark off, the trainer's float32 settings
    in force) and every call from then on copies the batch into the fixed
    buffers and replays the graph (`replays` counts them). On the CPU it
    runs the eager step.

    loss_and_grads(x, y) → (loss, gradients of `tx.params`): the body
    (default: the model's squared hinge loss and its autograd gradients;
    the sharded step passes its own, with the collectives). inputs(x, y)
    → the tensors the body takes (default: as given; the sharded step's
    picks this rank's rows, as views, copied into the fixed buffers
    without an allocation); the eager step moves them to the device.
    capture=False runs the eager step on a card too (the sharded step
    under gloo, whose collectives no graph can hold).

    The captured step reads its row of Adam's table through the device
    counter, so it may not outrun the table: at the table's end the table
    grows to twice the steps taken and the step is captured again on it
    (`captures` counts the captures). Every rank of a sharded step reaches
    that count at the same step, so all capture alike."""

    def __init__(self, config: NetworkConfig, model: QuantNet, tx: Adam,
                 loss_and_grads=None, inputs=_given, capture: bool = True):
        self.config, self.model, self.tx = config, model, tx
        self._body = loss_and_grads         # None: the model's own
        self.inputs = inputs
        self.device = tx.params[0].device
        self.graphs = capture and self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.graphs \
            else None
        self.graph = None
        self.x = self.y = self.loss = None
        self.addresses = ()
        self.warm = 0
        self.captures = 0
        self.replays = 0

    def loss_and_grads(self, x, y):
        """(loss, gradients): the body given, else the model's."""
        if self._body is not None:
            return self._body(x, y)
        with full_fp32():
            loss = squared_hinge_loss(self.model(x, train=True), y,
                                      self.config.num_classes)
            grads = torch.autograd.grad(loss, self.tx.params)
        return loss.detach(), grads

    def eager(self, x, y):
        """The eager step: forward, loss, gradients, `tx.update`."""
        x, y = (t.to(self.device) for t in self.inputs(x, y))
        loss, grads = self.loss_and_grads(x, y)
        self.tx.update(grads)
        return loss

    def _fit_table(self) -> None:
        """Give Adam's table the row of the next step: at its end it grows
        to twice the steps taken (a new tensor), and the graph captured on
        the old one is dropped."""
        if self.tx.count >= self.tx.table.shape[0]:
            self.tx.reserve(2 * (self.tx.count + 1))
            self.graph = None

    def _addresses(self):
        tx = self.tx
        return tuple(t.data_ptr() for t in itertools.chain(
            self.model.parameters(), self.model.buffers(), tx.params,
            tx.mu, tx.nu, (tx.table, tx.step)))

    def _capture(self, x, y) -> None:
        self.x = torch.empty(x.shape, dtype=x.dtype, device=self.device)
        self.y = torch.empty(y.shape, dtype=y.dtype, device=self.device)
        graph = torch.cuda.CUDAGraph()
        benchmark = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
        try:
            self.stream.wait_stream(torch.cuda.current_stream())
            with gc_paused(), torch.cuda.graph(graph, stream=self.stream):
                loss, grads = self.loss_and_grads(self.x, self.y)
                self.tx.apply(grads)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the training step "
                               f"(batch {tuple(x.shape)}) failed: {e}") \
                from e
        finally:
            torch.backends.cudnn.benchmark = benchmark
        self.graph, self.loss = graph, loss
        self.captures += 1
        self.addresses = self._addresses()

    def run(self, x, y, check: bool = True):
        """One step; on a card after the warm-up the loss is the fixed
        buffer, which the next step overwrites. check: hold the captured
        addresses against the live tensors first."""
        if not self.graphs:
            return self.eager(x, y)
        if self.graph is None and self.warm < WARMUP_STEPS:
            self.warm += 1
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                loss = self.eager(x, y)
            torch.cuda.current_stream().wait_stream(self.stream)
            return loss
        x, y = self.inputs(x, y)
        if check and self.graph is not None and \
                self._addresses() != self.addresses:
            raise RuntimeError("a parameter, statistic or Adam buffer was "
                               "rebound after the training step was "
                               "captured; update it in place")
        self._fit_table()
        if self.graph is None:
            self._capture(x, y)
        self.x.copy_(x)
        self.y.copy_(y)
        self.graph.replay()
        self.replays += 1
        self.tx.count += 1
        return self.loss

    def __call__(self, x, y):
        loss = self.run(x, y)
        return loss.clone() if loss is self.loss else loss


def make_train_step(config: NetworkConfig, model: QuantNet,
                    tx: Adam) -> TrainStep:
    """step(x, y) → the batch's loss (a device scalar); updates the model's
    parameters and running statistics in place (TrainStep)."""
    return TrainStep(config, model, tx)


def make_epoch_fn(config: NetworkConfig, model: QuantNet, tx: Adam,
                  steps_per_epoch: int, batch_size: int):
    """epoch(x_all, y_all, generator) → the epoch's step losses (a device
    tensor). The data stays where it lies; the shuffle is a `randperm` on
    its device from `generator`, and `steps_per_epoch·batch_size` images
    of it are used, as the reference's scan uses them. Each step's loss
    is written into one [steps] tensor. `epoch.step` is the TrainStep."""
    step = make_train_step(config, model, tx)
    n_scan = steps_per_epoch * batch_size

    def epoch(x_all, y_all, generator):
        perm = torch.randperm(x_all.shape[0], generator=generator,
                              device=x_all.device)[:n_scan]
        xs, ys = x_all[perm], y_all[perm]
        losses = torch.empty(steps_per_epoch, dtype=torch.float32,
                             device=x_all.device)
        for i in range(steps_per_epoch):
            lo = i * batch_size
            losses[i] = step.run(xs[lo:lo + batch_size],
                                 ys[lo:lo + batch_size], check=i == 0)
        return losses

    epoch.step = step
    return epoch


def make_eval_fn(config: NetworkConfig, model: QuantNet):
    """logits_fn(x) → float logits on the model's device, from the model's
    current parameters and running statistics (no gradient)."""
    def logits_fn(x):
        with torch.no_grad(), full_fp32():
            return model(x, train=False)
    return logits_fn


def evaluate(config, model, params, batch_stats, x, y, batch_size=1024,
             logits_fn=None):
    """Top-1 accuracy of the float model on (x, y) (numpy or tensors; x as
    `train_inputs` gives it). `params` / `batch_stats` (flax layout) are
    loaded into the model first unless they are None."""
    if params is not None:
        model.load_variables(params, batch_stats)
    if logits_fn is None:
        logits_fn = make_eval_fn(config, model)
    device = next(model.parameters()).device
    x = torch.as_tensor(x).to(device)
    y = torch.as_tensor(y).to(device)
    correct = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(0, len(x), batch_size):
        out = logits_fn(x[i:i + batch_size])
        correct += (out.argmax(-1) == y[i:i + batch_size]).sum()
    return int(correct) / len(x)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available; pass "
                           "device='cpu' to train on the CPU")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def train(config: NetworkConfig, dataset=None, *, epochs: int = 10,
          batch_size: int = 100, lr_start: float = 1e-3,
          lr_end: float = 1e-6, glorot_lr_scale: bool = True,
          seed: int = 0, checkpoint_path: Optional[str] = None,
          log_every: int = 0, max_train: Optional[int] = None,
          resume_from: Optional[str] = None,
          device="cuda") -> TrainResult:
    """Train a quantized network; returns the best-validation params.

    The initial kernels come from a CPU generator seeded `seed` (the same
    network on every device), the shuffle from a generator on `device`
    seeded `seed + 1`. `resume_from`: warm-start params / batch_stats from
    a checkpoint of either package. A checkpoint is written on strict
    improvement of the validation accuracy, and at epoch 0."""
    device = _device(device)
    if dataset is None:
        dataset = data_mod.load(config.dataset)
    x_train = data_mod.train_inputs(config.dataset, dataset.x_train,
                                    config.input_kind)
    x_test = data_mod.train_inputs(config.dataset, dataset.x_test,
                                   config.input_kind)
    y_train, y_test = dataset.y_train, dataset.y_test
    if max_train:
        x_train, y_train = x_train[:max_train], y_train[:max_train]

    model = QuantNet(config, generator=torch.Generator().manual_seed(seed))
    if resume_from:
        params, batch_stats, _ = load_checkpoint(resume_from)
        model.load_variables(params, batch_stats)
    model.to(device)

    # fewer images than batch_size → one step over everything
    batch_size = min(batch_size, len(x_train))
    steps_per_epoch = max(1, len(x_train) // batch_size)
    tx = Adam(model, epochs * steps_per_epoch, lr_start, lr_end,
              glorot_lr_scale)
    epoch_fn = make_epoch_fn(config, model, tx, steps_per_epoch, batch_size)
    eval_fn = make_eval_fn(config, model)

    x_dev = torch.from_numpy(np.ascontiguousarray(x_train)).to(device)
    y_dev = torch.from_numpy(np.asarray(y_train, np.int64)).to(device)
    xt_dev = torch.from_numpy(np.ascontiguousarray(x_test)).to(device)
    yt_dev = torch.from_numpy(np.asarray(y_test, np.int64)).to(device)
    shuffle = torch.Generator(device=device).manual_seed(seed + 1)

    best = TrainResult(params=None, batch_stats=None, model=model)
    best_state = {k: v.clone() for k, v in model.state_dict().items()}
    for epoch in range(epochs):
        t0 = time.perf_counter()
        losses = epoch_fn(x_dev, y_dev, shuffle).cpu().numpy()
        seconds = time.perf_counter() - t0
        val_acc = evaluate(config, model, None, None, xt_dev, yt_dev,
                           logits_fn=eval_fn)
        best.history.append({"epoch": epoch, "loss": float(np.mean(losses)),
                             "val_acc": val_acc,
                             "losses": losses.tolist(), "seconds": seconds})
        if log_every and (epoch % log_every == 0 or epoch == epochs - 1):
            print(f"[{config.name}] epoch {epoch}: loss={np.mean(losses):.4f} "
                  f"val_acc={val_acc:.4f}")
        if val_acc >= best.best_val_acc:
            improved = val_acc > best.best_val_acc
            best.best_val_acc = val_acc
            best_state = {k: v.clone() for k, v in model.state_dict().items()}
            if checkpoint_path and (improved or epoch == 0):
                v = model.variables(best_state)
                save_checkpoint(checkpoint_path, v["params"],
                                v["batch_stats"],
                                meta={"val_acc": val_acc, "epoch": epoch,
                                      "config": config.name})
    v = model.variables(best_state)
    best.params, best.batch_stats = v["params"], v["batch_stats"]
    return best


# --------------------------------------------------------------------------
# Checkpointing (.npz with the reference's keys: params/quant_0/kernel,
# batch_stats/bn_0/mean, meta/...; written and read by both packages)
# --------------------------------------------------------------------------

def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, params, batch_stats, meta: Dict = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {"params/" + "/".join(map(str, k)): _numpy(v)
            for k, v in _flatten(params).items()}
    flat.update({"batch_stats/" + "/".join(map(str, k)): _numpy(v)
                 for k, v in _flatten(batch_stats).items()})
    if meta:
        flat.update({f"meta/{k}": np.asarray(v) for k, v in meta.items()})
    np.savez(path, **flat)


def load_checkpoint(path: str):
    """(params, batch_stats, meta): nested dicts of numpy arrays."""
    params, batch_stats, meta = {}, {}, {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            kind, _, rest = key.partition("/")
            if kind == "params":
                params[tuple(rest.split("/"))] = z[key]
            elif kind == "batch_stats":
                batch_stats[tuple(rest.split("/"))] = z[key]
            else:
                meta[rest] = z[key]
    return _unflatten(params), _unflatten(batch_stats), meta
