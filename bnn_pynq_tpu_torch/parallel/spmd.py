"""What the tensor-parallel engines add to the shared serving surface
(runtime/engine.py's `Engine`): the data split, and serving with one rank
driving.

JAX runs a sharded engine from one process that addresses every device.
Here one process runs each mesh position (parallel/mesh.py), so an engine
is a set of per-rank objects that must run the same collective program in
the same order. Two ways to drive them:

- SPMD: every rank of the mesh builds the engine with the same arguments
  and calls the same methods with the same arguments (the tests do this).
  Each rank returns the full result.
- Serving: the rank at mesh position (0, 0) drives and owns the port's
  unchanged `BatchingServer`; the others follow:

      if rank == mesh.leader:                 # the leader
          engine.lead()
          server = BatchingServer(engine, ...)
          ...                                  # submit, load_parameters
          server.stop(); engine.close()
      else:
          engine.follow()                      # returns on close()

  After `lead()` every launch and swap on the leader first broadcasts a
  small header (op, parameter version, argmax, words, the padded batch's
  dtype and shape) and then its payload over the mesh; `follow()` loops on
  those headers and runs the same program. The header carries the
  parameter version, and a follower whose version differs raises, so no
  batch can mix parameters across ranks.

`load_parameters` checks the topology before any collective, broadcasts
the new artifact from the leader when leading, and publishes the new
shards with their programs under the lock that every launch holds, so
each rank switches at the same batch boundary, as the single-card engine
does.

Programs (runtime/engine.py's `Programs`): a launch runs this rank's rows
of the padded batch, a bucket rounded up to the 'data' axis, through the
program of their shape and variant, made at the key's first use, on every
rank alike; a capture's collectives are counted on its program. How a
program runs is decided from the mesh, never by catching a failure
(`execution_of`):
- 'graphs', a card under NCCL: a CUDA graph, captured after one eager run
  on the engine's stream (it creates the NCCL communicators, the ring's
  pairs included); the collectives are in the graph. A capture that fails
  raises, naming the engine, the mesh, the bucket and the variant;
- 'programs', the CPU: eager into the programs' fixed buffers (the tests'
  stand-in);
- 'eager', a card under gloo: gloo stages every collective through the
  host, which no graph can hold, so the engine keeps no programs.
Whether a rank warms, captures or replays depends only on the key and the
parameter set, which every rank shares, so the ranks' collectives stay in
step. A swap captures every program again on the new shards into a new
pool, in sorted key order; a follower does so on the leader's swap. The
serving header and batch are broadcast outside the programs.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional

import torch
import torch.distributed as dist

from bnn_pynq_tpu_torch.compiler.artifacts import CompiledNetwork
from bnn_pynq_tpu_torch.parallel import comm
from bnn_pynq_tpu_torch.parallel.mesh import Mesh
from bnn_pynq_tpu_torch.runtime.engine import (DEFAULT_BATCH_BUCKETS,
                                               EXECUTIONS, Engine,
                                               check_topology)

OP_STOP, OP_LAUNCH, OP_SWAP = 0, 1, 2
_DTYPES = (torch.int8, torch.int32)
_MAX_NDIM = 5
# op, version, argmax, words, dtype index, ndim, shape[_MAX_NDIM]
_HEADER_LEN = 6 + _MAX_NDIM


def execution_of(mesh: Mesh) -> str:
    """How a rank of `mesh` runs a forward (see EXECUTIONS)."""
    if mesh.device.type == "cpu":
        return "programs"
    return "graphs" if mesh.backend == "nccl" else "eager"


class SPMDEngine(Engine):
    """Base of TPInferenceEngine and OverlapTPEngine. A subclass provides
    `_load(compiled)` (this rank's shards, published as one unit) and
    `_forward(params, x_local)` (float32 logits of the whole batch,
    gathered over 'data', from this rank's rows of it)."""
    _collectives = staticmethod(comm.counts)

    def __init__(self, compiled: CompiledNetwork, mesh: Mesh,
                 batch_buckets=DEFAULT_BATCH_BUCKETS):
        if mesh.coords is None:
            raise ValueError("this rank is not in the mesh")
        self.mesh = mesh
        self._data_d = mesh.shape["data"]
        # header and swap traffic: NCCL takes CUDA tensors only
        self._wire = mesh.device if mesh.backend == "nccl" \
            else torch.device("cpu")
        self._leading = False
        self._version = 0
        super().__init__(compiled, mesh.device, batch_buckets,
                         execution_of(mesh), threading.RLock())

    def __repr__(self):
        return (f"{type(self).__name__}({self.config.name!r}, "
                f"mesh={dict(self.mesh.shape)}, execution="
                f"{self.execution!r}: {EXECUTIONS[self.execution]})")

    def _label(self, key: tuple) -> str:
        return super()._label(
            key, f"{type(self).__name__} on mesh {dict(self.mesh.shape)} "
                 f"(rank {dist.get_rank()}), ", "local ")

    # -- parameters ---------------------------------------------------------
    def load_parameters(self, compiled: CompiledNetwork):
        """Hot-swap parameters of the same topology on a live engine (on
        every rank in SPMD use; on the leader alone when leading)."""
        check_topology(self.config, compiled.config)
        with self._lock:
            version = self._version + 1
            if self._leading:
                self._send(OP_SWAP, version)
                compiled = comm.broadcast_object(compiled, self.mesh.leader,
                                                 self.mesh.group, self._wire)
            self._publish(compiled)
            self._version = version
        return self

    @property
    def version(self) -> int:
        """How many swaps this rank's parameters have seen."""
        return self._version

    # -- launch -------------------------------------------------------------
    # prepared input by default, as JAX's tensor-parallel engines take it
    logits_device = functools.partialmethod(Engine.logits_device,
                                            prepared=True)

    def launch_prepared(self, xd: torch.Tensor, *, argmax: bool = False,
                        words: bool = False) -> torch.Tensor:
        """Run on a padded device batch; returns the device output of the
        whole batch without waiting for it."""
        if xd.shape[0] % self._data_d:
            raise ValueError(f"batch {xd.shape[0]} does not split over "
                             f"'data' = {self._data_d}; pad it to a bucket")
        with self._lock:
            if self._leading:
                self._send(OP_LAUNCH, self._version, xd, argmax, words)
            return self._run(self._state, xd, argmax, words)

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's 'data' rows of a padded batch (a view)."""
        rows = x.shape[0] // self._data_d
        return x[self.mesh.coords[0] * rows:][:rows]

    def _run(self, state, x: torch.Tensor, argmax: bool,
             words: bool) -> torch.Tensor:
        """This rank's part of a launch on the padded batch x: its rows
        through the program of their shape and variant."""
        x_local = self._rows(x)
        key = (tuple(x_local.shape), x_local.dtype, argmax, words)
        return state.programs.run(key, x_local)

    def logits(self, x, *, prepared: bool = True):
        out, b = self.logits_device(x, prepared=prepared)
        return self.fetch(out)[:b]

    def classify(self, x, *, prepared: bool = True):
        """Class indices (int32); the argmax runs on the device."""
        out, b = self.logits_device(x, prepared=prepared, argmax=True)
        return self.fetch(out)[:b]

    # -- serving: one rank drives, the others follow -------------------------
    @property
    def is_leader(self) -> bool:
        return dist.get_rank() == self.mesh.leader

    def lead(self):
        """Drive the followers: from now on every launch and swap here is
        broadcast to them first. Only the rank at mesh position (0, 0)."""
        if not self.is_leader:
            raise RuntimeError("only the rank at mesh position (0, 0) "
                               "leads; the others call follow()")
        self._leading = True
        return self

    def close(self) -> None:
        """End the followers' loops (the leader, after its server stops)."""
        with self._lock:
            if self._leading:
                self._send(OP_STOP, self._version)
                self._leading = False

    def follow(self):
        """Run the leader's launches and swaps until it closes."""
        if self.is_leader:
            raise RuntimeError("the rank at mesh position (0, 0) leads")
        while True:
            op, version, x, argmax, words = self._receive()
            if op == OP_STOP:
                return self
            if op == OP_SWAP:
                compiled = comm.broadcast_object(None, self.mesh.leader,
                                                 self.mesh.group, self._wire)
                check_topology(self.config, compiled.config)
                self._publish(compiled)
                self._version = version
                continue
            if version != self._version:
                raise RuntimeError(f"launch at parameter version {version}, "
                                   f"this rank holds {self._version}")
            self._run(self._state, x, argmax, words)

    def _send(self, op: int, version: int, x: Optional[torch.Tensor] = None,
              argmax: bool = False, words: bool = False) -> None:
        hdr = torch.zeros(_HEADER_LEN, dtype=torch.int64)
        hdr[:4] = torch.tensor([op, version, int(argmax), int(words)])
        if x is not None:
            if x.ndim > _MAX_NDIM:
                raise ValueError(f"a batch of {x.ndim} dims")
            hdr[4] = _DTYPES.index(x.dtype)
            hdr[5] = x.ndim
            hdr[6:6 + x.ndim] = torch.tensor(x.shape)
        comm.broadcast(hdr.to(self._wire), self.mesh.leader, self.mesh.group)
        if x is not None:
            comm.broadcast(x.contiguous(), self.mesh.leader, self.mesh.group)

    def _receive(self):
        hdr = comm.broadcast(
            torch.zeros(_HEADER_LEN, dtype=torch.int64, device=self._wire),
            self.mesh.leader, self.mesh.group).tolist()
        op, version, argmax, words, dtype, ndim = hdr[:6]
        x = None
        if op == OP_LAUNCH:
            x = torch.empty(hdr[6:6 + ndim], dtype=_DTYPES[dtype],
                            device=self.device)
            x = comm.broadcast(x, self.mesh.leader, self.mesh.group)
        return op, version, x, bool(argmax), bool(words)
