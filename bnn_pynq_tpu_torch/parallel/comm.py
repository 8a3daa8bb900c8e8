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

Each function counts its calls in `<function>.calls` (a LaunchCounter),
also on a group of one member, where it moves nothing. The tests hold the
ring arm to "no `all_gather` between hidden layers" with these counts.

Gloo has no device send or receive and gathers host tensors only. Under
gloo every collective on a CUDA tensor therefore copies it to the host and
the result back, here and nowhere else, and counts the round trip in
`host_copies`; under NCCL a CUDA tensor never leaves the card. This is the
transport of ranks that share one card (parallel/launch.py).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from bnn_pynq_tpu_torch.ops._build import LaunchCounter

# collectives on a CUDA tensor that went through the host (gloo only)
host_copies = LaunchCounter()


def _staged(t: torch.Tensor, group) -> bool:
    """True where gloo must see a host copy of `t`."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_wire(t: torch.Tensor, group) -> torch.Tensor:
    if _staged(t, group):
        host_copies.add()
        return t.contiguous().cpu()
    return t.contiguous()


def _gather(t: torch.Tensor, group, axis: int) -> torch.Tensor:
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


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the members (a new tensor; `t` is left as it was)."""
    psum.calls.add()
    if dist.get_world_size(group) == 1:
        return t
    buf = _to_wire(t, group).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


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


for _fn in (all_gather, gather_batch, psum, ppermute_start, broadcast):
    _fn.calls = LaunchCounter()

COUNTED = {"all_gather": all_gather, "gather_batch": gather_batch,
           "psum": psum, "ppermute": ppermute_start, "broadcast": broadcast}


def counts() -> Dict[str, int]:
    """Calls of every collective (and host round trips) in this process."""
    out = {name: fn.calls.value for name, fn in COUNTED.items()}
    out["host_copies"] = host_copies.value
    return out


def reset_counts() -> None:
    for fn in COUNTED.values():
        fn.calls.reset()
    host_copies.reset()
