"""Inference engine on PyTorch tensors.

Port of `bnn_pynq_tpu/runtime/engine.py::InferenceEngine`: loads a
CompiledNetwork's integer parameters onto one device once and serves
classifications, padding batches to fixed buckets.

Runtimes:
- 'kernels': the route's kernels — on a CUDA device the CUDA kernels, on
  the CPU their plain versions. 'auto' (the JAX engine's default), 'tpu'
  and 'interpret', the JAX engine's names for its Pallas kernels compiled
  or interpreted, are accepted as names of 'kernels': which of the two a
  tensor runs follows from its device, not from the name. The engine
  keeps the resolved name in `runtime`. Routes (models/network.py):
  - 'mega' (default): `forward_mega`, the conv_chain / dense_block /
    fused_mlp stage list (and MobileNet-v1's depthwise_conv, ResNet-50's
    dense_residual: these two run on this route and 'ref' alone, the
    others raise NotImplementedError through
    `models/network.py::refuse_mega_only`). 's2d', the JAX package's
    default, computes the same function in a TPU layout, so it runs this
    stage list too;
  - 'xla' and 'xlaconv', the JAX package's other decoded-integer routes:
    `forward_xla` with conv_mode 'patches' and 'native', as JAX maps them,
    on the parameters `decode_params` made at load: every dot and conv a
    library call (`ops/int_dot.py`: cuBLASLt's int8 GEMM, cuDNN), no
    hand-written kernel; `library_calls()` counts the calls;
  - 'fused' (all-dense nets only, as in JAX): the whole net in one
    fused_mlp launch, which is what `forward_mega` runs on an MLP;
  - 'vpu' (W1A1 only), 'mxu', 'mxu_rm': the packed `forward`, every
    binary or 2-bit layer through `packed_matmul` on bit-packed words;
  - 'direct': `forward_direct`, every binary or 2-bit conv through
    `conv2d_direct` (no im2col); an MLP runs no conv kernel there.
- 'ref':     the reference forward (models/network.py::forward_ref),
  whatever the route.

Packed input, the reference's `binarizeAndPack` contract: the host packs
sign bits into uint32 words (`native.py`), 32× fewer bytes to the device
than int8 codes.
- `logits_packed`: W1A1 bipolar nets on the 'mxu'/'vpu' routes; the
  words go straight into the first packed matmul.
- `logits_words` / `words_device`: any route of a bipolar net; the words
  are unpacked to ±1 on the device in front of the route.
  `BatchingServer` feeds bipolar engines through `words_device`.
`upload` + `launch_prepared` split a launch into the host→device copy and
the run on the device-resident batch.

Input paths, by what the caller hands over:
- prepared int8 (`prepared=True`, or `prepare_host` in `prepare`):
  centred levels or ±1 codes, uploaded as they are;
- raw uint8 pixels (`logits` / `classify` with `prepared=False`, the
  path `Classifier` takes): uploaded as the caller gave them, padded with
  128, and centred or binarized by `prepare_device` inside the program,
  in front of the route: no host pass over the pixels;
- packed words (above): unpacked on the device.

Batches above the largest bucket: a conv net runs them one largest bucket
at a time, as the JAX engine does (`lax.map` over 1024-image chunks): each
chunk is prepared (on the host unless it is raw uint8), padded to its own
bucket, uploaded and launched before any result is fetched, so the host
prepares a chunk while the device runs the one before. An MLP runs one
forward on the batch padded to a multiple of the largest bucket (its one
kernel takes any number of rows).

One serving surface: `Engine` holds what every engine shares, this one
and the tensor-parallel engines of parallel/ alike: the buckets and their
padding, `upload`, `fetch`, `logits_device`, the program set and the
swap; `WordsInput` adds `words_device` and `warmup`.

Captured programs, the port's form of the JAX engine's one jitted
program per batch bucket: a 'kernels' engine runs each forward as a
program, one per (input shape, variant); a variant is logits, argmax,
words-logits or words-argmax. A program holds a fixed input buffer, the
forward and a fixed output buffer. `launch_prepared` copies the batch
into the input, runs the forward and returns a clone of the output, so
batches in flight never share an output. How a program runs is the
engine's `execution` (`EXECUTIONS`): on a card ('graphs') the forward is
a CUDA graph, captured at a shape's first use (or in `warmup`) after one
eager run that builds the kernels, then replayed, one graph launch a
forward; on the CPU ('programs') the same program runs the eager forward
into the same buffers; runtime='ref' ('eager') runs the eager forward on
either device and keeps no program. The graphs of one parameter set
share one memory pool; `load_parameters` captures every program again on
the new parameters before it publishes them. A capture that fails
raises, naming the shape and the variant; the engine never falls back to
the eager forward on a card.

Captures and replays hold the engine's lock, and a replay runs on the
caller's current stream (every caller in the port uses the default one),
so the copy in, the replay and the clone of two launches never
interleave. A capture records the kernels in the thread-local capture
mode on the engine's own stream, so other threads may go on issuing CUDA
work meanwhile (the server's uploader and collector); what they run is
not recorded. The HTTP server warms every bucket it can dispatch before
it accepts traffic, so it never captures under load.

A CUDA engine never runs on the CPU: `device="cuda"` without CUDA raises.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from bnn_pynq_tpu_torch import native
from bnn_pynq_tpu_torch.compiler.artifacts import (CompiledNetwork,
                                                   load_artifact)
from bnn_pynq_tpu_torch.models.config import (ConvSpec, DenseSpec,
                                              NetworkConfig)
from bnn_pynq_tpu_torch.models.network import (decode_params, forward,
                                               forward_direct, forward_mega,
                                               forward_ref, forward_xla,
                                               input_shape, refuse_mega_only)
from bnn_pynq_tpu_torch.models.params import Params, params_from_numpy
from bnn_pynq_tpu_torch.ops import (_build, conv_direct, conv_stack,
                                    depthwise, int_dot, matmul, ref,
                                    thresholds)
from bnn_pynq_tpu_torch.ops.fused_mlp import fused_mlp_forward
from bnn_pynq_tpu_torch.ops.packing import (packed_len, unpack_bits,
                                            words_to_tensor)
from bnn_pynq_tpu_torch.utils.profiling import span

DEFAULT_BATCH_BUCKETS = (1, 16, 64, 256, 1024)
# the JAX engine's names for its kernel runtimes, all 'kernels' here
KERNEL_RUNTIMES = ("auto", "kernels", "tpu", "interpret")
RUNTIMES = KERNEL_RUNTIMES + ("ref",)
# routes that run forward_mega ('s2d', the JAX package's name for the same
# function, and 'fused', its all-dense special case)
MEGA_ROUTES = ("mega", "s2d", "fused")
# the routes that run forward_xla, by the conv_mode each runs (JAX's map)
XLA_ROUTES = {"xla": "patches", "xlaconv": "native"}
ROUTES = MEGA_ROUTES + tuple(XLA_ROUTES) + ("mxu", "mxu_rm", "vpu", "direct")


def prepare_host(config: NetworkConfig, x: np.ndarray) -> np.ndarray:
    """uint8 images → engine input: binarized ±1 for bipolar nets, centred
    int8 for image nets (the host half of the reference's
    `binarizeAndPack`). Its device twin for uint8 is `prepare_device`."""
    x = np.asarray(x)
    if config.input_kind == "bipolar":
        flat = x.reshape(x.shape[0], -1)
        if x.dtype == np.uint8:
            return np.where(flat >= 128, 1, -1).astype(np.int8)
        return np.where(flat >= 0, 1, -1).astype(np.int8)
    if x.dtype == np.uint8:
        return (x.astype(np.int32) - 128).astype(np.int8)
    return x.astype(np.int8)


def prepare_device(config: NetworkConfig, xd: torch.Tensor) -> torch.Tensor:
    """uint8 images on the device → engine input, `prepare_host`'s uint8
    semantics: `[B, K]` ±1 (`x >= 128`) for bipolar nets, centred int8
    `x − 128` of the same shape for image nets. The bytes are read as
    int8 (`x − 256` where `x >= 128`), so centring is one op, the top bit
    flipped; binarizing is two, −1 − 2·(y >> 7)."""
    y = xd.view(torch.int8)
    if config.input_kind == "bipolar":
        return torch.rsub(y.reshape(y.shape[0], -1) >> 7, -1, alpha=2)
    return y ^ -128


def kernel_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count (process-wide), by kernel."""
    out = {"fused_mlp": fused_mlp_forward.launches.value,
           "conv_chain": conv_stack.conv_chain.launches.value,
           "dense_block": conv_stack.dense_block.launches.value,
           "conv2d_direct": conv_direct.conv2d_direct.launches.value,
           "conv_chain_direct": conv_direct.conv_chain_direct.launches.value,
           "depthwise_conv": depthwise.depthwise_conv.launches.value,
           "threshold_search": thresholds.threshold_search.value,
           "pooled_epilogue": thresholds.pooled_epilogue.value,
           "residual_epilogue": thresholds.residual_epilogue.value}
    out.update({f"packed_matmul[{r}]": c.value
                for r, c in matmul.packed_matmul.launches.items()})
    return out


def library_calls() -> Dict[str, int]:
    """Every library product's call count (process-wide): the
    decoded-integer route's `int_mm` (cuBLASLt's int8 GEMM) and `conv2d`
    (cuDNN), and `int_matmul_ref`, the reference's float64 product."""
    return {"int_mm": int_dot.int_matmul.calls.value,
            "conv2d": int_dot.int_conv2d.calls.value,
            "int_matmul_ref": ref.int_matmul_ref.calls.value}


def _moved(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in after.items() if n != before[k]}


class Program:
    """One forward at one input shape and variant on fixed buffers: `x`
    (the input), `out` (the output) and, on a card, the CUDA graph that
    reads the one and writes the other. `launches`: the kernel launches
    its capture counted (a replay goes through no wrapper, so it counts
    none); `library`: likewise the calls of `library_calls()`;
    `collectives`: likewise the calls of `collectives()` (the parallel
    engines pass `parallel/comm.py::counts`; none here);
    `replays`: how many times the graph ran."""

    def __init__(self, body, x: torch.Tensor, label: str,
                 collectives=dict):
        self.body = body                    # x → output, the eager forward
        self.label = label
        self.x = torch.zeros_like(x)
        self.out: Optional[torch.Tensor] = None
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.library: Dict[str, int] = {}
        self.collectives: Dict[str, int] = {}
        self._count_collectives = collectives
        self.replays = _build.LaunchCounter()

    def capture(self, stream, pool) -> None:
        """One eager run on `stream` (it builds the kernels), then the
        forward captured on it into `pool`; raises, naming the shape and
        the variant, if the capture fails."""
        try:
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                self.body(self.x)
                before = kernel_launches()
                before_library = library_calls()
                before_calls = self._count_collectives()
                graph = torch.cuda.CUDAGraph()
                with _build.gc_paused():
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    try:
                        out = self.body(self.x)
                    finally:
                        graph.capture_end()
            torch.cuda.current_stream().wait_stream(stream)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.label} "
                               f"failed: {e}") from e
        self.launches = _moved(before, kernel_launches())
        self.library = _moved(before_library, library_calls())
        self.collectives = _moved(before_calls, self._count_collectives())
        self.graph, self.out = graph, out

    def __call__(self, xd: torch.Tensor) -> torch.Tensor:
        with span("bnn.program.copy_in"):
            self.x.copy_(xd)
        with span("bnn.program.replay"):
            if self.graph is None:          # the CPU: the eager forward
                out = self.body(self.x)
                if self.out is None:
                    self.out = out
                else:
                    self.out.copy_(out)
            else:
                self.graph.replay()
                self.replays.add()
        with span("bnn.program.clone"):
            return self.out.clone()


EXECUTIONS = {
    "graphs": "a CUDA graph a program",
    "programs": "programs on the CPU, eager into fixed buffers",
    "eager": "eager, no program kept: runtime='ref', or gloo, which stages "
             "every collective through the host, where no graph can hold "
             "it"}


class Programs(dict):
    """One parameter set's programs by key, in one pool, and how a call
    runs (`execution`, see EXECUTIONS): through the key's program, made at
    the key's first use and captured on `stream` under 'graphs'; under
    'eager' the forward itself, with no program kept. `body(key)` is key's
    forward, `label(key)` names it in a failed capture, `collectives`
    counts what a capture communicates (Program's)."""

    def __init__(self, execution: str, stream, body, label,
                 collectives=dict):
        super().__init__()
        self.execution, self.stream = execution, stream
        self.body, self.label, self.collectives = body, label, collectives
        # a pool whose graphs have all been released takes no new capture
        # (PyTorch's allocator asserts), so each set has its own
        self.pool = torch.cuda.graph_pool_handle() \
            if execution == "graphs" else None

    def make(self, key, x: torch.Tensor) -> Program:
        """A new program for `key` at x's shape (captured under
        'graphs'), kept once it could capture."""
        prog = Program(self.body(key), x, self.label(key), self.collectives)
        if self.execution == "graphs":
            prog.capture(self.stream, self.pool)
        self[key] = prog
        return prog

    def run(self, key, x: torch.Tensor) -> torch.Tensor:
        """key's forward on x, through its program."""
        prog = self.get(key)
        if prog is None:
            if self.execution == "eager":
                return self.body(key)(x)
            prog = self.make(key, x)
        return prog(x)


def check_topology(old: NetworkConfig, new: NetworkConfig) -> None:
    """Raise ValueError unless `new` has `old`'s layers and widths."""
    if new.layers != old.layers or new.wbits != old.wbits or \
            new.abits != old.abits:
        raise ValueError("parameter topology mismatch; build a new "
                         "engine for a different network")


def pad_rows(x: np.ndarray, rows: int) -> np.ndarray:
    """A leading-batch array padded to `rows`: uint8 pixels with 128 (they
    centre to 0), anything else with 0."""
    if rows == x.shape[0]:
        return x
    pad = np.full((rows - x.shape[0],) + x.shape[1:],
                  128 if x.dtype == np.uint8 else 0, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


def to_device(x: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`; uint32 words as their int32 bit
    pattern."""
    if x.dtype == np.uint32:
        return words_to_tensor(x).to(device)
    return torch.from_numpy(np.require(x, requirements=("C", "W"))).to(device)


class _State(NamedTuple):
    """What an engine publishes as one unit: its parameters and the
    programs that run on them."""
    params: tuple
    programs: Programs


class Engine:
    """The serving surface every engine shares: buckets, padding, upload,
    fetch, the program set, and the swap that makes every program again
    before it publishes. A subclass provides `_load(compiled)` (its
    parameters on its device), `_forward(params, x)` (float32 logits of
    the batch from x) and `launch_prepared`; `_data_d`, the rows a bucket
    splits into, and `_collectives`, what a capture counts of
    communication, are the tensor-parallel engines'."""
    _data_d = 1
    _collectives = dict

    def __init__(self, compiled: CompiledNetwork, device: torch.device,
                 batch_buckets: Sequence[int], execution: str, lock):
        self.compiled = compiled
        self.config: NetworkConfig = compiled.config
        self.device = device
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.execution = execution
        self._lock = lock                   # captures, replays and swaps
        self._stream = torch.cuda.Stream(device) \
            if execution == "graphs" else None
        self._state = self._new_state(compiled)

    def _new_state(self, compiled: CompiledNetwork) -> _State:
        params = self._load(compiled)       # not the state: no cycle

        def body(key):
            argmax, words = key[2:]
            return lambda x: self._eager(params, x, argmax, words)
        return _State(params, Programs(self.execution, self._stream, body,
                                       self._label, self._collectives))

    def _label(self, key: tuple, where: str = "", local: str = "") -> str:
        shape, dtype, argmax, words = key
        return (f"{where}bucket {shape[0] * self._data_d} ({local}input "
                f"{tuple(shape)} {dtype}), variant "
                f"{'words-' if words else ''}"
                f"{'argmax' if argmax else 'logits'}")

    def _eager(self, params, x: torch.Tensor, argmax: bool,
               words: bool) -> torch.Tensor:
        """The eager forward on `params`: what a program runs. words: x
        holds host-packed sign words, unpacked to ±1 first; argmax: int32
        classes."""
        if words:
            x = unpack_bits(x, int(np.prod(self.config.input_shape)))
        out = self._forward(params, x)
        if argmax:
            out = out.argmax(dim=-1).to(torch.int32)
        return out

    @property
    def programs(self) -> Programs:
        """The published programs by (input shape, dtype, argmax, words);
        none under 'eager'."""
        return self._state.programs

    def _publish(self, compiled: CompiledNetwork,
                 state: Optional[_State] = None) -> None:
        """Make every program of the published set on `state` (new
        parameters from `compiled` if None), in sorted key order (the
        ranks of a mesh capture their collectives in one order), then
        publish both in one assignment; the old graphs go once the device
        has run their last replay. The caller holds the lock."""
        if state is None:
            state = self._new_state(compiled)
        old = self._state.programs
        for key in sorted(old, key=lambda k: (k[0], str(k[1])) + k[2:]):
            state.programs.make(key, old[key].x)
        self._state, self.compiled = state, compiled
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- input and output -------------------------------------------------
    def prepare(self, x: np.ndarray) -> np.ndarray:
        return prepare_host(self.config, x)

    def _bucket(self, b: int) -> int:
        dd = self._data_d
        for s in self.batch_buckets:
            s = -(-s // dd) * dd            # a bucket must split over 'data'
            if b <= s:
                return s
        top = -(-self.batch_buckets[-1] // dd) * dd
        return -(-b // top) * top

    def _pad_to_bucket(self, x: np.ndarray):
        """Pad a leading-batch array up to the next bucket size
        (`pad_rows`); returns (padded, true_batch)."""
        b = x.shape[0]
        with span("bnn.engine.pad", b):
            return pad_rows(x, self._bucket(b)), b

    def upload(self, x_padded: np.ndarray) -> torch.Tensor:
        """Host→device copy of an already padded batch: prepared int8
        input, raw uint8 pixels, or uint32 words (as their int32 bit
        pattern)."""
        x = np.asarray(x_padded)
        with span("bnn.engine.upload", x.shape[0]):
            return to_device(x, self.device)

    def fetch(self, dev_out: torch.Tensor) -> np.ndarray:
        """Device output → numpy (waits for the device)."""
        with span("bnn.engine.fetch", dev_out.shape[0]):
            return dev_out.cpu().numpy()

    def logits_device(self, x: np.ndarray, *, prepared: bool = False,
                      argmax: bool = False) -> Tuple[torch.Tensor, int]:
        """Launch without fetching: returns (device_out, true_batch).
        argmax=True gives int32 class indices computed on the device."""
        if not prepared:
            x = self.prepare(x)
        x, b = self._pad_to_bucket(np.asarray(x))
        return self.launch_prepared(self.upload(x), argmax=argmax), b


class WordsInput:
    """An Engine's packed-words launch (bipolar nets: host-packed sign
    words, unpacked on the device in front of the forward) and the warmup
    of what a server dispatches. `_raw_pixels`: warmup also runs the raw
    uint8 pair that `Classifier` sends."""
    _raw_pixels = False

    def _check_bipolar(self) -> None:
        if self.config.input_kind != "bipolar":
            raise ValueError("packed word input is for bipolar-input "
                             "networks (MLPs); conv nets take int8 images")

    def words_device(self, words: np.ndarray, *,
                     argmax: bool = False) -> Tuple[torch.Tensor, int]:
        """Launch from host-packed uint32 words [B, Kw] without fetching:
        the packed-transport twin of logits_device, used by the serving
        dispatcher for bipolar nets. Returns (device_out, true_batch)."""
        self._check_bipolar()
        words, b = self._pad_to_bucket(np.asarray(words, dtype=np.uint32))
        return self.launch_prepared(self.upload(words), argmax=argmax,
                                    words=True), b

    def warmup(self, batch: int = 1, *, serving: bool = True):
        """Run the engine's programs once at `batch`'s bucket: builds the
        kernels (first use in the process) before live traffic: logits of
        prepared int8 (and, with `_raw_pixels`, logits and classify of
        raw uint8). serving also runs what the server dispatches: the
        device-argmax launch and, for bipolar nets, the packed-words
        launches. On a tensor-parallel engine, a call on every rank."""
        dummy = np.zeros(input_shape(self.config, batch), dtype=np.int8)
        self.logits(dummy, prepared=True)
        if self._raw_pixels:
            pixels = np.zeros((batch,) + tuple(self.config.input_shape),
                              dtype=np.uint8)
            self.logits(pixels, prepared=False)
            self.classify(pixels, prepared=False)
        if serving:
            outs = [self.logits_device(dummy, prepared=True, argmax=True)[0]]
            if self.config.input_kind == "bipolar":
                words = np.zeros((batch, packed_len(
                    int(np.prod(self.config.input_shape)))), dtype=np.uint32)
                outs += [self.words_device(words, argmax=am)[0]
                         for am in (True, False)]
            for out in outs:
                self.fetch(out)
        return self


class InferenceEngine(WordsInput, Engine):
    """Loads a CompiledNetwork onto a device and serves classifications."""
    _raw_pixels = True

    def __init__(self, compiled: CompiledNetwork, *, device="cuda",
                 runtime: str = "kernels", route: str = "mega",
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS):
        if runtime not in RUNTIMES:
            raise ValueError(f"unknown runtime {runtime!r}; one of "
                             f"{RUNTIMES}")
        if runtime in KERNEL_RUNTIMES:
            runtime = "kernels"
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}; one of {ROUTES}")
        if runtime == "kernels" and route not in ("mega", "s2d"):
            refuse_mega_only(compiled.config, f"route {route!r}")
        if route == "vpu" and runtime == "kernels" and \
                compiled.config.bits != 1:
            raise ValueError("route='vpu' (XNOR popcount) requires a W1A1 "
                             "network")
        if route == "fused" and runtime == "kernels" and not all(
                isinstance(s, DenseSpec) for s in compiled.config.layers):
            raise ValueError("route='fused' (the whole net in one fused_mlp "
                             "launch) supports all-dense MLPs only")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available; "
                               "pass device='cpu' to run the plain versions")
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        self.runtime = runtime
        self.route = route
        self.usecPerImage: Optional[float] = None
        super().__init__(compiled, device, batch_buckets,
                         "eager" if runtime == "ref" else "graphs"
                         if device.type == "cuda" else "programs",
                         threading.Lock())

    def _load(self, compiled: CompiledNetwork) -> Params:
        """(layers, out_scale, out_bias) on the device: `decode_params`'
        layers on the 'xla' and 'xlaconv' routes of the kernels runtime,
        else `params_from_numpy`'s."""
        layers, out_scale, out_bias = params_from_numpy(
            self.config, compiled.layers, compiled.out_scale,
            compiled.out_bias, self.device)
        if self.runtime == "kernels" and self.route in XLA_ROUTES:
            layers = decode_params(self.config, layers)
        return layers, out_scale, out_bias

    def load_parameters(self, compiled: CompiledNetwork):
        """Hot-swap parameters of the same topology. Every program already
        captured is captured again on the new parameters, then the
        parameters and programs are published by one assignment under the
        engine's lock; every launch reads that unit once, so a batch never
        mixes old and new parameters. The old graphs are released after
        the device has run their last replay."""
        check_topology(self.config, compiled.config)
        state = self._new_state(compiled)
        with self._lock:
            self._publish(compiled, state)
        return self

    # -- inference --------------------------------------------------------
    def _forward(self, params: Params, xd: torch.Tensor) -> torch.Tensor:
        """The route's logits on `params` (layers, out_scale, out_bias).
        uint8 input is raw pixels, prepared here by `prepare_device`."""
        layers, out_scale, out_bias = params
        if xd.dtype == torch.uint8:
            xd = prepare_device(self.config, xd)
        if self.runtime == "kernels" and self.route in MEGA_ROUTES:
            return forward_mega(self.config, layers, xd, out_scale, out_bias)
        if self.runtime == "ref":
            acc = forward_ref(self.config, layers, xd)
        elif self.route in XLA_ROUTES:
            acc = forward_xla(self.config, layers, xd,
                              conv_mode=XLA_ROUTES[self.route])
        elif self.route == "direct":
            acc = forward_direct(self.config, layers, xd)
        else:
            acc = forward(self.config, layers, xd, route=self.route)
        # two ops, as JAX computes them: no fused multiply-add
        return acc.to(torch.float32) * out_scale + out_bias

    def launch_prepared(self, xd: torch.Tensor, *, argmax: bool = False,
                        words: bool = False) -> torch.Tensor:
        """Run on a device-resident, padded batch; returns the device
        output without waiting for it. words=True: xd holds host-packed
        sign words, unpacked to ±1 on the device first (any route). The
        'kernels' runtime runs the program of xd's shape and the variant,
        captured here at its first use."""
        with span("bnn.engine.launch", xd.shape[0]):
            key = (tuple(xd.shape), xd.dtype, argmax, words)
            with self._lock:
                return self._state.programs.run(key, xd)

    def _chunks(self, b: int):
        """[lo, hi) ranges a batch of b runs in: one, or for a conv net
        above the largest bucket one per largest bucket."""
        top = self.batch_buckets[-1]
        if b <= top or not any(isinstance(s, ConvSpec)
                               for s in self.config.layers):
            return [(0, b)]
        return [(lo, min(lo + top, b)) for lo in range(0, b, top)]

    def _run(self, x: np.ndarray, *, argmax: bool, words: bool = False,
             prepared: bool = True):
        """Prepare (unless prepared), pad, upload and launch every chunk of
        the batch, then fetch. Unprepared uint8 goes up raw, to be
        prepared inside the program; any other dtype is prepared on the
        host. `usecPerImage` covers the uploads, the launches and the
        fetch."""
        x = np.asarray(x)
        b = x.shape[0]
        raw = not prepared and x.dtype == np.uint8
        with span("bnn.engine.run", b):
            outs = []
            spent = 0.0
            for lo, hi in self._chunks(b):
                xc = x[lo:hi] if prepared or raw else self.prepare(x[lo:hi])
                xc, n = self._pad_to_bucket(xc)
                t0 = time.perf_counter()
                outs.append((self.launch_prepared(
                    self.upload(xc), argmax=argmax, words=words), n))
                spent += time.perf_counter() - t0
            t0 = time.perf_counter()
            parts = [self.fetch(out)[:n] for out, n in outs]
            self.usecPerImage = (spent + time.perf_counter() - t0) * 1e6 / b
            return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def logits(self, x: np.ndarray, *, prepared: bool = False) -> np.ndarray:
        """Float logits [B, num_classes]."""
        return self._run(x, argmax=False, prepared=prepared)

    def classify(self, x: np.ndarray, *, prepared: bool = False) -> np.ndarray:
        """Class indices [B] (int32); the argmax runs on the device."""
        return self._run(x, argmax=True, prepared=prepared)

    def classify_one(self, image: np.ndarray) -> int:
        return int(self.classify(image[None])[0])

    # -- packed input -----------------------------------------------------
    def logits_packed(self, x_uint8: np.ndarray) -> np.ndarray:
        """Float logits from images binarized and bit-packed on the host;
        the device consumes the uint32 words directly in the first packed
        matmul. W1A1 bipolar nets on the 'mxu'/'vpu' routes only."""
        if self.config.input_kind != "bipolar" or self.config.bits != 1:
            raise ValueError("packed input is for W1A1 bipolar networks")
        if self.runtime == "ref" or self.route not in ("mxu", "vpu"):
            raise ValueError(
                "packed input requires a packed route ('mxu'/'vpu') on the "
                f"kernels runtime; route={self.route!r}, runtime="
                f"{self.runtime!r} consumes int8 codes — use logits_words() "
                "for the on-device-unpack path")
        return self._run(native.binarize_pack(x_uint8), argmax=False)

    def logits_words(self, x_uint8: np.ndarray) -> np.ndarray:
        """Float logits from host-packed sign words, unpacked to ±1 on the
        device in front of the engine's route (any route, bipolar nets);
        equal to prepare() + logits()."""
        self._check_bipolar()
        return self._run(native.binarize_pack(x_uint8), argmax=False,
                         words=True)

    @classmethod
    def from_artifact(cls, path: str, **kw) -> "InferenceEngine":
        return cls(load_artifact(path), **kw)

    @classmethod
    def from_training(cls, config, params, batch_stats,
                      **kw) -> "InferenceEngine":
        from bnn_pynq_tpu_torch.compiler.finnthesizer import compile_network
        return cls(compile_network(config, params, batch_stats), **kw)
