"""What the tensor-parallel engines share: buckets, the data split, the
parameter swap, and serving with one rank driving.

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
shards with one assignment under the lock that every launch holds, so each
rank switches at the same batch boundary, as the single-card engine does
(runtime/engine.py).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bnn_pynq_tpu_torch.compiler.artifacts import CompiledNetwork
from bnn_pynq_tpu_torch.ops.packing import unpack_bits, words_to_tensor
from bnn_pynq_tpu_torch.parallel import comm
from bnn_pynq_tpu_torch.parallel.mesh import Mesh
from bnn_pynq_tpu_torch.runtime.engine import prepare_host

DEFAULT_BATCH_BUCKETS = (1, 16, 64, 256, 1024)

OP_STOP, OP_LAUNCH, OP_SWAP = 0, 1, 2
_DTYPES = (torch.int8, torch.int32)
_MAX_NDIM = 5
# op, version, argmax, words, dtype index, ndim, shape[_MAX_NDIM]
_HEADER_LEN = 6 + _MAX_NDIM


def check_topology(old, new) -> None:
    """Raise ValueError unless `new` has `old`'s layers and widths."""
    if new.layers != old.layers or new.wbits != old.wbits or \
            new.abits != old.abits:
        raise ValueError("parameter topology mismatch; build a new "
                         "engine for a different network")


class SPMDEngine:
    """Base of TPInferenceEngine and OverlapTPEngine. A subclass provides
    `_shard(compiled)` (this rank's parameters, published as one unit)
    and `_forward(state, x_local)` (float32 logits of the whole batch,
    gathered over 'data', from this rank's rows of it)."""

    def __init__(self, compiled: CompiledNetwork, mesh: Mesh,
                 batch_buckets=DEFAULT_BATCH_BUCKETS):
        if mesh.coords is None:
            raise ValueError("this rank is not in the mesh")
        self.compiled = compiled
        self.config = compiled.config
        self.mesh = mesh
        self.device = mesh.device
        self._data_d = mesh.shape["data"]
        self.batch_buckets = tuple(sorted(batch_buckets))
        # header and swap traffic: NCCL takes CUDA tensors only
        self._wire = mesh.device if mesh.backend == "nccl" \
            else torch.device("cpu")
        self._lock = threading.RLock()
        self._leading = False
        self._version = 0
        self._state = self._shard(compiled)

    def _shard(self, compiled: CompiledNetwork):
        raise NotImplementedError

    def _forward(self, state, x_local: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

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
            self._publish(compiled, version)
        return self

    @property
    def version(self) -> int:
        """How many swaps this rank's parameters have seen."""
        return self._version

    def _publish(self, compiled: CompiledNetwork, version: int) -> None:
        state = self._shard(compiled)
        self._state = state
        self.compiled, self._version = compiled, version

    # -- input --------------------------------------------------------------
    def prepare(self, x):
        return prepare_host(self.config, x)

    def _bucket(self, b: int) -> int:
        dd = self._data_d
        for s in self.batch_buckets:
            s = -(-s // dd) * dd          # a bucket must split over 'data'
            if b <= s:
                return s
        top = -(-self.batch_buckets[-1] // dd) * dd
        return -(-b // top) * top

    def _pad_to_bucket(self, x: np.ndarray):
        b = x.shape[0]
        bucket = self._bucket(b)
        if bucket != b:
            x = np.concatenate(
                [x, np.zeros((bucket - b,) + x.shape[1:], x.dtype)])
        return x, b

    def upload(self, x_padded: np.ndarray) -> torch.Tensor:
        """Host→device copy of a padded batch: int8 input, or uint32 words
        (as their int32 bit pattern)."""
        x = np.asarray(x_padded)
        if x.dtype == np.uint32:
            t = words_to_tensor(x)
        else:
            t = torch.from_numpy(np.require(x, requirements=("C", "W")))
        return t.to(self.device)

    # -- launch -------------------------------------------------------------
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
            return self._program(self._state, xd, argmax, words)

    def _program(self, state, x: torch.Tensor, argmax: bool,
                 words: bool) -> torch.Tensor:
        if words:
            x = unpack_bits(x, int(np.prod(self.config.input_shape)))
        rows = x.shape[0] // self._data_d
        lo = self.mesh.coords[0] * rows
        out = self._forward(state, x[lo:lo + rows])
        if argmax:
            out = out.argmax(dim=-1).to(torch.int32)
        return out

    def fetch(self, dev_out: torch.Tensor) -> np.ndarray:
        """Device output → numpy (waits for the device)."""
        return dev_out.cpu().numpy()

    def logits_device(self, x, *, prepared: bool = True,
                      argmax: bool = False) -> Tuple[torch.Tensor, int]:
        """Launch without fetching: (device output, true batch)."""
        if not prepared:
            x = self.prepare(x)
        x, b = self._pad_to_bucket(np.asarray(x))
        return self.launch_prepared(self.upload(x), argmax=argmax), b

    def logits(self, x, *, prepared: bool = True) -> np.ndarray:
        out, b = self.logits_device(x, prepared=prepared)
        return self.fetch(out)[:b]

    def classify(self, x, *, prepared: bool = True) -> np.ndarray:
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
                self._publish(compiled, version)
                continue
            if version != self._version:
                raise RuntimeError(f"launch at parameter version {version}, "
                                   f"this rank holds {self._version}")
            self._program(self._state, x, argmax, words)

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
