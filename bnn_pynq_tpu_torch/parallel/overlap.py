"""Collective/compute-overlapped tensor parallelism.

Port of `bnn_pynq_tpu/parallel/overlap.py`. The plain TP engine
(parallel/tp.py) all-gathers every layer's output channels before the next
layer. This one never gathers between hidden layers: activations stay
output-shard-resident, and each next layer consumes them with a RING. At
step t a rank computes with the shard it holds against the matching
slice of its (column-sharded) weights while `comm.ppermute_start` sends
that shard to its right neighbour; the transfer is issued before the
partial product and waited after it, so the transfer of shard t+1
overlaps the compute on shard t.

Layer shardings (each rank holds model column `my` of d):
- the first layer, on the replicated input: its output columns only;
- hidden dense W [K, N]: columns [K, N/d], all rows; thresholds likewise;
- a conv [kh, kw, C, N]: columns, all input channels; conv is linear in
  C, so ring step idx convolves the C-shard of rank idx with the rows of
  input-channel block idx and sums int32 partials;
- the last dense W [K, ncls]: row block `my` [K/d, ncls]; each rank's
  partial product over the shard it holds, finished by one `psum`;
- the first dense after a conv: its rows permuted at load into the order
  a C-sharded local flatten gives (`reorder_dense_rows_for_csharding`);
- the batch over 'data'; every rank returns the logits of the whole batch.

`blocking=True` builds the same math with an all-gather before each layer
instead of rings: the control arm of every overlap-vs-blocking comparison
and a second exactness witness.

Local compute, on the card, on the port's kernels (activations are codes
between layers, as the kernels take them):
- the first conv, on the replicated raw image: `conv_chain` with one layer
  and `input_levels` (csrc/conv_chain.cu, `bnn_conv_layer`) on the rank's
  columns, on `sliding_window`'s patches (`input_patches`) where it
  strides;
- every other conv: `conv2d_direct` (csrc/conv_direct.cu), its int32
  epilogue for a ring step (the shard's `WeightMatrix.wsum` folds the level
  offset, so a partial over a C-slice is exact; a strided conv's step runs
  at kernel 1 on the block's patches), thresholded in the kernel on the
  blocking arm;
- the dense layers, their ring partials and the last layer: cuBLASLt's
  int8 GEMM (`ops/int_dot.py::int_matmul`), where JAX runs XLA's int8 dot
  outside any Pallas kernel, on weights stored K-contiguous at load, the
  ring's row blocks cut there too; pools: `maxpool2d`, channelwise, no
  communication.
JAX's `_conv_bf16_exact` works around a TPU int8-conv hang and has no
counterpart here.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from bnn_pynq_tpu_torch.compiler.artifacts import CompiledNetwork
from bnn_pynq_tpu_torch.models.network import make_plan, prepare_input
from bnn_pynq_tpu_torch.models.params import (WeightMatrix, unpack_levels,
                                              weight_matrix)
from bnn_pynq_tpu_torch.ops.conv import maxpool2d, sliding_window
from bnn_pynq_tpu_torch.ops.conv_direct import conv2d_direct
from bnn_pynq_tpu_torch.ops.conv_stack import conv_chain
from bnn_pynq_tpu_torch.ops.int_dot import int_matmul, k_contiguous
from bnn_pynq_tpu_torch.ops.thresholds import (codes_to_values,
                                               multithreshold)
from bnn_pynq_tpu_torch.parallel import comm
from bnn_pynq_tpu_torch.parallel.spmd import SPMDEngine
from bnn_pynq_tpu_torch.runtime.engine import (DEFAULT_BATCH_BUCKETS,
                                               EXECUTIONS, Programs,
                                               WordsInput)

ARMS = ("ring", "blocking", "auto")


def reorder_dense_rows_for_csharding(w, hw: int, c: int, d: int):
    """Permute dense rows from flatten order (hw, c) to the order a
    C-sharded local flatten produces: (c_block, hw, c_within). Row block
    `idx` of the result is then the contiguous [idx·K/d, (idx+1)·K/d)
    slice the ring expects."""
    k, _ = w.shape
    if k != hw * c or c % d != 0:
        raise ValueError(f"rows {k} != hw*c {hw * c} or C {c} % d {d}")
    cs = c // d
    idx = np.arange(k)
    h_, cc = idx // c, idx % c
    new = (cc // cs) * (hw * cs) + h_ * cs + (cc % cs)
    out = np.empty_like(np.asarray(w))
    out[new] = np.asarray(w)[idx]
    return out


def _validate_divisibility(config, plan, d):
    for i, lp in enumerate(plan):
        if lp.kind == "pool":
            continue
        if not lp.last and lp.n % d != 0:
            raise ValueError(
                f"layer {i}: output width {lp.n} not divisible by "
                f"model axis {d}")
        if lp.last and lp.k % d != 0:
            raise ValueError(
                f"final layer contraction {lp.k} not divisible by "
                f"model axis {d}")


@dataclass(frozen=True)
class Shard:
    """A layer's weights on one rank: its output columns over the whole
    contraction (`full`: the blocking arm, the replicated first layer,
    every arm on a model axis of 1, and the last layer's row block), and
    the same columns cut into the model axis's contraction blocks
    (`blocks[idx]`: the ring's step on the shard of rank idx; none on a
    model axis of 1, the first layer or the last). A conv's are
    WeightMatrix: [K²·C, N] in (ki, kj, c) order, where a C-block is no
    contiguous row range. A dense layer's are int8 [K, N] K-contiguous,
    `int_matmul`'s operand, where a row block of one is no K-contiguous
    matrix. So the blocks are built once, at load."""
    full: object
    blocks: Tuple[object, ...]


def layer_levels(config, lp, p) -> np.ndarray:
    """A compiled layer's weights as int8 levels [K, N]."""
    if "w_int8" in p:
        return np.array(p["w_int8"], dtype=np.int8)
    return unpack_levels(p["w_packed"], lp.k, config.bits)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _levels(a, device) -> torch.Tensor:
    """int8 levels [K, N] on `device`, stored K-contiguous."""
    return k_contiguous(_tensor(a, device))


def shard_overlap_params(compiled: CompiledNetwork, mesh):
    """This rank's parameters: (weights, thresholds, out_scale, out_bias),
    laid out as the module docstring says, on the mesh's device."""
    config, device = compiled.config, mesh.device
    plan = make_plan(config)
    d, my = mesh.shape["model"], mesh.coords[1]
    _validate_divisibility(config, plan, d)
    weights, thrs = [], []
    h, w = (config.input_shape[0], config.input_shape[1]) \
        if config.input_kind == "int8" else (1, 1)
    prev_hw_c = None       # (h*w, c) at the conv→dense flatten
    first_dense_after_conv = config.input_kind == "int8"
    for lp, p in zip(plan, compiled.layers):
        if lp.kind == "pool":
            h //= lp.window
            w //= lp.window
            continue
        kn = layer_levels(config, lp, p)
        nl = lp.n // d
        cols = slice(my * nl, (my + 1) * nl)
        if lp.kind in ("conv", "conv_int8"):
            if lp.last:
                raise NotImplementedError("the overlap engine ends in a "
                                          "dense layer")
            c_in = lp.k // (lp.kernel * lp.kernel)
            hwio = kn[:, cols].reshape(lp.kernel, lp.kernel, c_in, nl)
            blocks = ()
            if weights and d > 1:         # a ring layer (not the first)
                cs = c_in // d
                blocks = tuple(
                    weight_matrix(_tensor(
                        hwio[:, :, i * cs:(i + 1) * cs].reshape(-1, nl),
                        device)) for i in range(d))
            weights.append(Shard(
                full=weight_matrix(_tensor(kn[:, cols], device)),
                blocks=blocks))
            h = (h - lp.kernel) // lp.stride + 1
            w = (w - lp.kernel) // lp.stride + 1
            prev_hw_c = (h * w, lp.n)
        else:
            if first_dense_after_conv and prev_hw_c is not None:
                kn = reorder_dense_rows_for_csharding(
                    kn, prev_hw_c[0], prev_hw_c[1], d)
                first_dense_after_conv = False
            if lp.last:
                kl = lp.k // d
                weights.append(Shard(full=_levels(
                    kn[my * kl:(my + 1) * kl], device), blocks=()))
            else:
                ks = lp.k // d
                blocks = tuple(
                    _levels(kn[i * ks:(i + 1) * ks, cols], device)
                    for i in range(d)) if weights and d > 1 else ()
                weights.append(Shard(full=_levels(kn[:, cols], device),
                                     blocks=blocks))
        if not lp.last:
            thrs.append(_tensor(np.asarray(p["thr"], np.int32)[:, cols],
                                device))
    scale = _tensor(np.asarray(compiled.out_scale, np.float32), device)
    bias = _tensor(np.asarray(compiled.out_bias, np.float32), device)
    return tuple(weights), tuple(thrs), scale, bias


def first_conv(act: torch.Tensor, w: WeightMatrix, thr, lp, abits: int):
    """The first conv, on the raw int8 image (levels): `conv_chain`, on
    prebuilt patches where it strides."""
    if thr is None:
        raise NotImplementedError("the first conv runs conv_chain: "
                                  "thresholded")
    patches = lp.stride != 1
    if patches:
        act = sliding_window(act, lp.kernel, lp.kernel, lp.stride)
    return conv_chain(act, [w], [thr], kernel=lp.kernel, abits=abits,
                      input_patches=patches, input_levels=True)


def conv_partial(act: torch.Tensor, w: WeightMatrix, lp,
                 abits: int) -> torch.Tensor:
    """int32 partial sums of a conv over the channel block of codes `act`
    (a ring step): `conv2d_direct` without thresholds, on prebuilt patches
    at kernel 1 where the conv strides (its accumulator path is stride-1
    only)."""
    kernel = lp.kernel
    if lp.stride != 1:
        act = sliding_window(act, kernel, kernel, lp.stride)
        kernel = 1
    return conv2d_direct(act, w, None, kernel=kernel, abits=abits)


def dense(act: torch.Tensor, w: torch.Tensor, thr, abits: int, *,
          levels: bool = False) -> torch.Tensor:
    """Codes (or levels) [B, K] · int8 levels [K, N] (K-contiguous):
    int32, or codes with thresholds."""
    vals = act if levels else codes_to_values(act, abits)
    acc = int_matmul(vals, w)
    return acc if thr is None else multithreshold(acc, thr)


def _ring(group, my: int, d: int, cur: torch.Tensor, partial_fn):
    """Accumulate partial_fn(shard_idx, shard) over all d shards while the
    held shard moves to the right neighbour: the transfer of the next
    shard is in flight while the partial of the held one is computed."""
    acc = None
    for t in range(d):
        idx = (my - t) % d
        pending = comm.ppermute_start(cur, group) if t != d - 1 else None
        part = partial_fn(idx, cur)
        acc = part if acc is None else acc + part
        if pending is not None:
            cur = pending.wait()
    return acc


def make_overlap_tp_forward(config, mesh, *, blocking: bool = False):
    """fn(weights, thrs, out_scale, out_bias, x_local) → float32 logits of
    the whole batch, on every rank. x_local is this rank's rows of the
    batch ('data'); weights and thrs are `shard_overlap_params`'s.
    Supports all-dense MLPs and conv networks (conv → pool → dense)."""
    plan = make_plan(config)
    abits = config.abits
    d = mesh.shape["model"]
    _validate_divisibility(config, plan, d)
    my = mesh.coords[1]
    mg, dg = mesh.model_group, mesh.data_group
    # on a model axis of 1 a rank holds every shard: both arms run one
    # thresholded product a layer, and only blocking counts its (empty)
    # gather
    whole_input = blocking or d == 1

    def gathered(act, axis):
        return comm.all_gather(act, mg, axis=axis) if blocking else act

    def fn(weights, thrs, out_scale, out_bias, x):
        levels_in = config.input_kind == "int8"
        act = x.to(torch.int8) if levels_in else prepare_input(config, x)
        replicated_in = True   # the first layer's input is whole
        wi = 0
        for lp in plan:
            if lp.kind == "pool":
                act = maxpool2d(act, lp.window)    # channelwise: no comm
                continue
            w = weights[wi]
            thr = None if lp.last else thrs[wi]
            if lp.kind in ("conv", "conv_int8"):
                if replicated_in:
                    vals = act if levels_in else codes_to_values(act, abits)
                    act = first_conv(vals, w.full, thr, lp, abits)
                elif whole_input:
                    act = conv2d_direct(gathered(act, 3), w.full, thr,
                                        kernel=lp.kernel, abits=abits,
                                        stride=lp.stride)
                else:
                    def conv_part(idx, cur, w=w, lp=lp):
                        return conv_partial(cur, w.blocks[idx], lp, abits)
                    act = multithreshold(_ring(mg, my, d, act, conv_part),
                                         thr)
            else:
                act = act.reshape(act.shape[0], -1)
                if lp.last:
                    # row-sharded final layer: partial dot + one psum
                    acc = comm.psum(dense(act, w.full, None, abits), mg)
                    logits = acc.to(torch.float32) * out_scale + out_bias
                    return comm.gather_batch(logits, dg)
                if replicated_in:
                    act = dense(act, w.full, thr, abits, levels=levels_in)
                elif whole_input:
                    act = dense(gathered(act, 1), w.full, thr, abits)
                else:
                    def dense_part(idx, cur, w=w):
                        return dense(cur, w.blocks[idx], None, abits)
                    act = multithreshold(_ring(mg, my, d, act, dense_part),
                                         thr)
            replicated_in = False
            wi += 1
        raise AssertionError("plan had no final dense layer")

    return fn


def elapsed_s(fn, iters: int, device: torch.device) -> float:
    """Seconds per call of fn over `iters` calls: CUDA events on the card,
    the host clock on the CPU (where every op is synchronous)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


class OverlapTPEngine(WordsInput, SPMDEngine):
    """Tensor-parallel engine with overlapped collectives (same logits API
    as runtime.InferenceEngine; MLPs and conv networks; the serving hooks
    of runtime/engine.py's `Engine` and `WordsInput` and the
    driving/following modes of parallel/spmd.py).

    arm: 'ring' (default), 'blocking', or 'auto': build both, time them on
    a calibration batch and keep the faster. The ring serializes d small
    partial products where blocking does one gather and one wide product,
    so neither wins everywhere. Under 'auto' every rank runs both arms
    (they are collective programs) and checks that they agree within
    rtol=atol=1e-5; the rank at mesh position (0, 0) times them (CUDA
    events on the card) and broadcasts its choice, so every rank keeps the
    same arm. Each arm is timed as it will run: its program, captured once
    at the calibration batch under NCCL (into a pool of its own, dropped
    with it), as JAX times its compiled arms. The choice and its
    measurement are on `.arm`, `.arm_reason` and in repr(), beside the
    engine's `execution` (parallel/spmd.py)."""

    def __init__(self, compiled: CompiledNetwork, mesh, blocking: bool = False,
                 arm: str = None, calib_batch: int = None,
                 calib_iters: int = 10, batch_buckets=DEFAULT_BATCH_BUCKETS):
        if arm is None:
            arm = "blocking" if blocking else "ring"
        if arm not in ARMS:
            raise ValueError(f"arm must be ring|blocking|auto, got {arm!r}")
        super().__init__(compiled, mesh, batch_buckets)
        if arm == "auto":
            self._fn, self.arm, self.arm_reason = self._pick_arm(
                calib_batch, calib_iters)
        else:
            self._fn = make_overlap_tp_forward(self.config, mesh,
                                               blocking=(arm == "blocking"))
            self.arm = arm
            self.arm_reason = "forced by caller"

    def _load(self, compiled):
        return shard_overlap_params(compiled, self.mesh)

    def _forward(self, params, x_local):
        return self._fn(*params, x_local)

    def _pick_arm(self, calib_batch, iters):
        dd = self._data_d
        batch = -(-(calib_batch or max(32, 8 * dd)) // dd) * dd
        rng = np.random.default_rng(0)
        if self.config.input_kind == "bipolar":
            x = rng.choice([-1, 1], size=(
                batch, int(np.prod(self.config.input_shape)))).astype(np.int8)
        else:
            x = rng.integers(-128, 128, size=(
                batch,) + self.config.input_shape).astype(np.int8)
        xl = self._rows(self.upload(x))
        params = self._state.params
        fns = {name: make_overlap_tp_forward(self.config, self.mesh,
                                             blocking=(name == "blocking"))
               for name in ("ring", "blocking")}
        # the calibration graphs go with this call: a pool of their own
        calibration = Programs(
            self.execution, self._stream,
            lambda name: functools.partial(fns[name], *params),
            lambda name: f"OverlapTPEngine on mesh {dict(self.mesh.shape)}, "
                         f"calibration batch {batch}, arm {name}",
            comm.counts)
        times, outs = [], {}
        for name in fns:
            run = functools.partial(calibration.run, name, xl)
            outs[name] = run().cpu().numpy()       # warm
            times.append(elapsed_s(run, iters, self.device))
        np.testing.assert_allclose(outs["ring"], outs["blocking"],
                                   rtol=1e-5, atol=1e-5)
        # the leader's clock decides, so that every rank keeps one arm
        best = float(np.argmin(times))
        got = comm.broadcast(
            torch.tensor([best] + times, dtype=torch.float64,
                         device=self._wire),
            self.mesh.leader, self.mesh.group).tolist()
        name = ("ring", "blocking")[int(got[0])]
        clock = "CUDA events" if self.device.type == "cuda" else "host clock"
        reason = (f"measured ring {got[1] * 1e3:.2f} ms vs blocking "
                  f"{got[2] * 1e3:.2f} ms ({self.execution}) at batch "
                  f"{batch} on mesh "
                  f"{dict(self.mesh.shape)} (rank {self.mesh.leader}'s "
                  f"{clock})")
        return fns[name], name, reason

    def __repr__(self):
        return (f"OverlapTPEngine({self.config.name!r}, "
                f"mesh={dict(self.mesh.shape)}, arm={self.arm!r}, "
                f"execution={self.execution!r}: "
                f"{EXECUTIONS[self.execution]}; {self.arm_reason})")
