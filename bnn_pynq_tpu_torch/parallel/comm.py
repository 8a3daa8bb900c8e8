"""The collectives of the tensor-parallel engines, each counting its calls.

Counterparts of the JAX package's `lax` collectives inside `shard_map`:
- `all_gather(t, group, axis)` ← `lax.all_gather(..., tiled=True)`: the
  members' tensors concatenated along `axis` in group-rank order;
- `psum(t, group)` ← `lax.psum`;
- `ppermute_start(t, group).wait()` ← the ring's `lax.ppermute` with
  perm i → i+1: each member sends `t` to its right neighbour and receives
  its left neighbour's. It is issued with `dist.batch_isend_irecv` before
  the caller's compute and waited after it, so the transfer of the next
  shard overlaps the compute on the one held (parallel/overlap.py);
- `gather_batch(t, group)`: the data-parallel rows gathered along axis 0,
  so that every rank returns what JAX's single-controller call returns;
- `broadcast(t, src, group)` and `broadcast_object`: the serving header,
  batch and swapped artifact from the driving rank (parallel/spmd.py).

Sharded training (parallel/train_sharded.py) differentiates through three
more, Megatron's split of the collectives between forward and backward,
each a `torch.autograd.Function`:
- `gather_model(t, group, axis)`: all-gather forward; the backward takes
  this member's slice of the incoming gradient, which every member holds
  whole and equal (its consumer is either replicated, or column-parallel
  behind `copy_to_model`, whose backward made it whole);
- `copy_to_model(t, group)`: identity forward; the backward sums the
  input's gradient over the group, since each member's columns give only
  their part of it;
- `mean_over_data(t, group)`: the mean over the members forward and
  backward (the BatchNorm statistics of the global batch).
`torch.distributed.nn.functional.all_gather` sums the gradient over the
group in its backward instead, which is m times too large wherever the
consumer is replicated. The backward sums go through the same staged
all-reduce as `psum`, on NCCL and gloo alike.

Each function counts its calls in `<function>.calls` (a LaunchCounter),
also on a group of one member, where it moves nothing. The tests hold the
ring arm to "no `all_gather` between hidden layers" with these counts.

Gloo has no device send or receive and gathers host tensors only. Under
gloo every collective on a CUDA tensor therefore copies it to the host and
the result back, here and nowhere else, and counts the round trip in
`host_copies`; under NCCL a CUDA tensor never leaves the card. This is the
transport of ranks that share one card (parallel/launch.py).

CUDA graphs: under NCCL the collectives, the ring's send and receive
included, are captured into a graph like any kernel (the engines'
programs, the sharded training step); the counters move when the Python
call runs, that is at an eager run and at a capture, never at a replay. A
host copy cannot be captured, so a collective on a gloo group called
while this thread's current stream is capturing raises at once, before
anything is staged.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from bnn_pynq_tpu_torch.ops._build import LaunchCounter

# collectives on a CUDA tensor that went through the host (gloo only)
host_copies = LaunchCounter()


def _capturing() -> bool:
    """True while this thread's current CUDA stream is being captured."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _check_capture(group) -> None:
    if dist.get_backend(group) == "gloo" and _capturing():
        raise RuntimeError(
            "a gloo collective inside a CUDA graph capture: gloo stages "
            "every CUDA tensor through the host, which no graph can hold; "
            "under gloo the engines run their eager forward")


def _staged(t: torch.Tensor, group) -> bool:
    """True where gloo must see a host copy of `t`."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_wire(t: torch.Tensor, group) -> torch.Tensor:
    if _staged(t, group):
        host_copies.add()
        return t.contiguous().cpu()
    return t.contiguous()


def _gather(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    _check_capture(group)
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = _to_wire(t, group)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=axis).to(t.device)


def all_gather(t: torch.Tensor, group, axis: int = -1) -> torch.Tensor:
    """Tiled all-gather: members' tensors concatenated along `axis`."""
    all_gather.calls.add()
    return _gather(t, group, axis)


def gather_batch(t: torch.Tensor, group) -> torch.Tensor:
    """The data-parallel rows of every member, in order, along axis 0."""
    gather_batch.calls.add()
    return _gather(t, group, 0)


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    _check_capture(group)
    if dist.get_world_size(group) == 1:
        return t
    buf = _to_wire(t, group).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the members (a new tensor; `t` is left as it was)."""
    psum.calls.add()
    return _sum(t, group)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, axis):
        gather_model.calls.add()
        ctx.group, ctx.axis, ctx.width = group, axis, t.shape[axis]
        return _gather(t, group, axis)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.axis, me * ctx.width, ctx.width), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        copy_to_model.calls.add()
        return _sum(g, ctx.group), None


class _MeanOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        mean_over_data.calls.add()
        ctx.group = group
        return _sum(t, group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        mean_over_data.calls.add()
        return _sum(g, ctx.group) / dist.get_world_size(ctx.group), None


def gather_model(t: torch.Tensor, group, axis: int = 1) -> torch.Tensor:
    """Members' column shards concatenated along `axis`; its gradient is
    this member's slice (counted once a forward)."""
    return _GatherModel.apply(t, group, axis)


def copy_to_model(t: torch.Tensor, group) -> torch.Tensor:
    """`t` itself; its gradient is summed over the group (counted once a
    backward)."""
    return _CopyToModel.apply(t, group)


def mean_over_data(t: torch.Tensor, group) -> torch.Tensor:
    """The members' mean of `t`, and of its gradient (counted in both
    directions)."""
    return _MeanOverData.apply(t, group)


class _Pending:
    """A ring transfer in flight; `wait()` returns the received tensor."""

    def __init__(self, works, buf, device):
        self._works, self._buf, self._device = works, buf, device

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._buf.to(self._device)


def ppermute_start(t: torch.Tensor, group) -> _Pending:
    """Send `t` to the right neighbour in `group`, receive the left one's
    (same shape and dtype); returns at once."""
    _check_capture(group)
    ppermute_start.calls.add()
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    src = _to_wire(t, group)
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src,
                      dist.get_global_rank(group, (me + 1) % n), group),
           dist.P2POp(dist.irecv, buf,
                      dist.get_global_rank(group, (me - 1) % n), group)]
    return _Pending(dist.batch_isend_irecv(ops), buf, t.device)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """`t` of global rank `src` on every member; returns the result (a
    new tensor where `t` had to go through the host)."""
    _check_capture(group)
    broadcast.calls.add()
    wire = _to_wire(t, group)
    dist.broadcast(wire, src=src, group=group)
    if wire is t:
        return t
    return wire.to(t.device)


def broadcast_object(obj, src: int, group, device: torch.device):
    """A picklable object of global rank `src` on every member (the
    swap's artifact); `device` is where NCCL wants the bytes."""
    broadcast.calls.add()
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group, device=device)
    return box[0]


COUNTED = {"all_gather": all_gather, "gather_batch": gather_batch,
           "psum": psum, "ppermute": ppermute_start, "broadcast": broadcast,
           "gather_model": gather_model, "copy_to_model": copy_to_model,
           "mean_over_data": mean_over_data}
for _fn in COUNTED.values():
    _fn.calls = LaunchCounter()


def counts() -> Dict[str, int]:
    """Calls of every collective (and host round trips) in this process."""
    out = {name: fn.calls.value for name, fn in COUNTED.items()}
    out["host_copies"] = host_copies.value
    return out


def reset_counts() -> None:
    for fn in COUNTED.values():
        fn.calls.reset()
    host_copies.reset()
