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

Programs, the port's form of JAX's one compiled program per shape: a
launch runs this rank's rows of the padded batch through the program of
their shape and variant (runtime/engine.py's `Program`: a fixed input, the
forward, a fixed output, a clone out), made at the key's first use, on
every rank alike. How a program runs is decided from the mesh, never by
catching a failure (`execution`):
- 'graphs', a card under NCCL: a CUDA graph, captured after one eager run
  on the engine's stream (it creates the NCCL communicators, the ring's
  pairs included) in thread-local mode into the engine's pool, then
  replayed; the collectives are in the graph. A capture that fails
  raises, naming the engine, the mesh, the bucket and the variant;
- 'programs', the CPU: the same programs run the eager forward into their
  fixed buffers (the tests' stand-in);
- 'eager', a card under gloo: gloo stages every collective through the
  host, which no graph can hold, so the engine runs its eager forward and
  keeps no programs.
Whether a rank warms, captures or replays depends only on the key and the
parameter set, which every rank shares, so the ranks' collectives stay in
step. A swap captures every program again on the new shards into a new
pool, on every rank in sorted key order, before it publishes them; a
follower does so on the leader's swap. The serving header and batch are
broadcast outside the programs.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bnn_pynq_tpu_torch.compiler.artifacts import CompiledNetwork
from bnn_pynq_tpu_torch.ops.packing import unpack_bits, words_to_tensor
from bnn_pynq_tpu_torch.parallel import comm
from bnn_pynq_tpu_torch.parallel.mesh import Mesh
from bnn_pynq_tpu_torch.runtime.engine import Program, prepare_host

DEFAULT_BATCH_BUCKETS = (1, 16, 64, 256, 1024)

OP_STOP, OP_LAUNCH, OP_SWAP = 0, 1, 2
_DTYPES = (torch.int8, torch.int32)
_MAX_NDIM = 5
# op, version, argmax, words, dtype index, ndim, shape[_MAX_NDIM]
_HEADER_LEN = 6 + _MAX_NDIM


EXECUTIONS = {
    "graphs": "a CUDA graph a program (NCCL)",
    "programs": "programs on the CPU, eager into fixed buffers",
    "eager": "eager: gloo stages every collective through the host, which "
             "no graph can hold"}


def execution_of(mesh: Mesh) -> str:
    """How a rank of `mesh` runs a forward (see EXECUTIONS)."""
    if mesh.device.type == "cpu":
        return "programs"
    return "graphs" if mesh.backend == "nccl" else "eager"


class Programs(dict):
    """One parameter set's programs by key, in one pool, and how a call
    runs: through the key's program, made at the key's first use and
    captured on `stream` under 'graphs'; under 'eager' the body itself,
    with no program kept. The engines and make_gspmd_engine's `logits`
    decide their launches here."""

    def __init__(self, execution: str, stream):
        super().__init__()
        self.execution, self.stream = execution, stream
        # a pool whose graphs have all been released takes no new capture
        # (PyTorch's allocator asserts), so each set has its own
        self.pool = torch.cuda.graph_pool_handle() \
            if execution == "graphs" else None

    def make(self, key, body, x: torch.Tensor, label) -> Program:
        """The program of `key` (label() names it in a failed capture),
        made at x's shape, its collectives counted, if there is none."""
        prog = self.get(key)
        if prog is None:
            prog = Program(body, x, label(), collectives=comm.counts)
            if self.execution == "graphs":
                prog.capture(self.stream, self.pool)
            self[key] = prog                # kept once it could capture
        return prog

    def run(self, key, body, x: torch.Tensor, label) -> torch.Tensor:
        """body(x) through the program of `key`."""
        if self.execution == "eager":
            return body(x)
        return self.make(key, body, x, label)(x)


class _State(NamedTuple):
    """What a rank publishes as one unit: its shards and the programs that
    run on them."""
    params: tuple
    programs: Programs


def _key_order(key):
    shape, dtype, argmax, words = key
    return shape, str(dtype), argmax, words


def check_topology(old, new) -> None:
    """Raise ValueError unless `new` has `old`'s layers and widths."""
    if new.layers != old.layers or new.wbits != old.wbits or \
            new.abits != old.abits:
        raise ValueError("parameter topology mismatch; build a new "
                         "engine for a different network")


class SPMDEngine:
    """Base of TPInferenceEngine and OverlapTPEngine. A subclass provides
    `_shard(compiled)` (this rank's parameters, published as one unit)
    and `_forward(params, x_local)` (float32 logits of the whole batch,
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
        self.execution = execution_of(mesh)
        self._stream = torch.cuda.Stream(self.device) \
            if self.execution == "graphs" else None
        self._state = self._new_state(compiled)

    def _shard(self, compiled: CompiledNetwork):
        raise NotImplementedError

    def _forward(self, params, x_local: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _new_state(self, compiled: CompiledNetwork) -> _State:
        return _State(self._shard(compiled),
                      Programs(self.execution, self._stream))

    def __repr__(self):
        return (f"{type(self).__name__}({self.config.name!r}, "
                f"mesh={dict(self.mesh.shape)}, execution="
                f"{self.execution!r}: {EXECUTIONS[self.execution]})")

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
        """Shard `compiled`, make every program of the old set on it, then
        publish both in one assignment; the old graphs go once the device
        has run their last replay."""
        state = self._new_state(compiled)
        old = self._state
        for key in sorted(old.programs, key=_key_order):
            self._program(state, key, old.programs[key].x, run=False)
        self._state = state
        self.compiled, self._version = compiled, version
        if self._stream is not None:
            torch.cuda.synchronize(self.device)
        del old

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
            return self._run(self._state, xd, argmax, words)

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's 'data' rows of a padded batch (a view)."""
        rows = x.shape[0] // self._data_d
        return x[self.mesh.coords[0] * rows:][:rows]

    def _eager(self, params, x_local: torch.Tensor, argmax: bool,
               words: bool) -> torch.Tensor:
        """The eager forward from this rank's rows: what a program runs."""
        if words:
            x_local = unpack_bits(x_local,
                                  int(np.prod(self.config.input_shape)))
        out = self._forward(params, x_local)
        if argmax:
            out = out.argmax(dim=-1).to(torch.int32)
        return out

    def _program(self, state: _State, key: tuple, x_local: torch.Tensor,
                 run: bool):
        """The program of `key` on `state`'s shards: run on x_local, or
        only made (a swap's re-capture)."""
        shape, dtype, argmax, words = key
        params = state.params               # not the state: no cycle

        def body(x):
            return self._eager(params, x, argmax, words)

        def label():
            return (f"{type(self).__name__} on mesh {dict(self.mesh.shape)} "
                    f"(rank {dist.get_rank()}), bucket "
                    f"{shape[0] * self._data_d} (local input {tuple(shape)} "
                    f"{dtype}), variant {'words-' if words else ''}"
                    f"{'argmax' if argmax else 'logits'}")
        if run:
            return state.programs.run(key, body, x_local, label)
        return state.programs.make(key, body, x_local, label)

    def _run(self, state: _State, x: torch.Tensor, argmax: bool,
             words: bool) -> torch.Tensor:
        """This rank's part of a launch on the padded batch x: its rows
        through the program of their shape and variant, made here at the
        key's first use (or the eager forward, see `execution`)."""
        x_local = self._rows(x)
        key = (tuple(x_local.shape), x_local.dtype, argmax, words)
        return self._program(state, key, x_local, run=True)

    @property
    def programs(self) -> Programs:
        """The published programs by (local input shape, dtype, argmax,
        words); none under 'eager'."""
        return self._state.programs

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
