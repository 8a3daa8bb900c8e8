"""Spawn a world of N ranks on this host and collect each rank's result.

The port's own harness (JAX drives every device from one process; PyTorch
runs one process per device). The tests, `parallel/benchmark.py` and
`chip_smoke.py` all start their worlds here:

    from bnn_pynq_tpu_torch.parallel.launch import run_world
    results = run_world(fn, 4, args=(compiled,), device="cpu", timeout=120)

`fn(*args)` runs in every rank after `init_process_group`, and its return
value (numpy arrays and plain Python data; no CUDA tensors) comes back in
rank order. Each rank is a fresh process of `torch.multiprocessing`'s spawn
context, so `fn` must be importable by its module path (a module-level
function) and everything it needs travels in `args`.

Backend: `nccl` when every rank has a card of its own; `gloo` on the CPU
and when several ranks share a card (NCCL refuses two ranks on one GPU).
The rendezvous store is a TCPStore that the caller's process opens on a
port of the kernel's choice on 127.0.0.1 and holds for the world's life:
a port picked free and bound later by a rank could be taken in between by
a concurrent world. Gloo binds the loopback interface (`GLOO_SOCKET_IFNAME`
lo, all ranks are on this host), and every group creation ends in a
barrier (`TORCH_DIST_INIT_BARRIER`), so no rank connects to a group that a
slower rank is still building.

The world has a hard deadline. A rank that raises, exits or is still
running at the deadline ends the world: the other ranks are killed and
`run_world` raises `WorldError` with every rank's traceback or the tail of
its output, so a hung collective fails its caller instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, List, Optional, Sequence

import torch

HOST = "127.0.0.1"
# how much of a failed rank's output `WorldError` quotes
TAIL_BYTES = 4000
# seconds a rank that has sent its result gets to tear its group down
EXIT_GRACE_S = 10.0


class WorldError(RuntimeError):
    """A rank raised, died or missed the world's deadline."""


def backend_for(device: str, world_size: int) -> str:
    """`nccl` when each of `world_size` ranks gets a card of its own, else
    `gloo`."""
    if torch.device(device).type == "cuda" and \
            world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(fn, rank, world_size, port, backend, device, args, log_path,
               conn, timeout):
    """One rank: redirect its output to its log, join the group, run fn,
    send ("ok", result) or ("error", traceback) to the parent."""
    log = open(log_path, "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    sys.stdout = sys.stderr = log
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR=HOST, MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("TORCH_DIST_INIT_BARRIER", "1")
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        else:
            # the card make_mesh gives this rank; the kernels' launchers
            # take the current device, under gloo as under nccl
            torch.cuda.set_device(rank % torch.cuda.device_count())
        limit = datetime.timedelta(seconds=timeout)
        store = dist.TCPStore(HOST, port, world_size, is_master=False,
                              timeout=limit)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, timeout=limit)
        result = fn(*args)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    conn.send(("ok", result))
    dist.destroy_process_group()


def _tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - TAIL_BYTES))
            return f.read().decode(errors="replace")
    except OSError as e:
        return f"(no output: {e})"


def run_world(fn: Callable[..., Any], world_size: int, *,
              args: Sequence = (), device: str = "cuda",
              timeout: float = 120.0) -> List[Any]:
    """Run `fn(*args)` in `world_size` spawned ranks; their results in rank
    order. Raises WorldError if any rank fails or the deadline passes.
    device="cuda" (default) puts rank r on card r % device_count and
    raises without CUDA; "cpu" runs CPU ranks."""
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available; "
                               "pass device='cpu' to run CPU ranks")
        # build the kernels once here: every rank then loads the library
        from bnn_pynq_tpu_torch.ops import _build
        _build.library()
    import torch.distributed as dist
    backend = backend_for(device, world_size)
    ctx = mp.get_context("spawn")
    store = dist.TCPStore(HOST, 0, None, is_master=True,
                          timeout=datetime.timedelta(seconds=timeout),
                          wait_for_workers=False)
    port = store.port
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="bnn_world_") as tmp:
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(world_size)]
        procs, conns = [], []
        try:
            for r in range(world_size):
                recv, send = ctx.Pipe(duplex=False)
                p = ctx.Process(
                    target=_rank_main, daemon=True,
                    args=(fn, r, world_size, port, backend, device,
                          tuple(args), logs[r], send, timeout))
                p.start()
                send.close()
                procs.append(p)
                conns.append(recv)
            results, failure = _collect(procs, conns, deadline, timeout)
            if failure is None:
                for p in procs:
                    p.join(timeout=EXIT_GRACE_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            for c in conns:
                c.close()
        if failure is not None:
            parts = [f"world of {world_size} ({backend}, {device}): "
                     f"{failure}"]
            for r, (p, path) in enumerate(zip(procs, logs)):
                status = results[r][0] if results[r] else \
                    f"exit code {p.exitcode}"
                detail = results[r][1] if results[r] and \
                    results[r][0] == "error" else _tail(path)
                parts.append(f"--- rank {r} ({status}) ---\n{detail}")
            raise WorldError("\n".join(parts))
    return [res for _, res in results]


def _collect(procs, conns, deadline, timeout):
    """Wait for every rank's message; stop at the first failure. Returns
    (messages by rank, failure description or None)."""
    results: List[Optional[tuple]] = [None] * len(procs)
    while any(r is None for r in results):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return results, f"deadline of {timeout:.0f} s passed"
        pending = [i for i, r in enumerate(results) if r is None]
        wait([conns[i] for i in pending] + [procs[i].sentinel
                                             for i in pending],
             timeout=min(remaining, 1.0))
        for i in pending:
            if conns[i].poll():
                try:
                    results[i] = conns[i].recv()
                except EOFError:        # it closed its end unsent: dead
                    procs[i].join(timeout=5)
                    return results, _no_result(procs, i)
                if results[i][0] == "error":
                    return results, f"rank {i} raised"
            elif not procs[i].is_alive() and not conns[i].poll():
                return results, _no_result(procs, i)
    return results, None


def _no_result(procs, i) -> str:
    return f"rank {i} exited with code {procs[i].exitcode} and no result"
