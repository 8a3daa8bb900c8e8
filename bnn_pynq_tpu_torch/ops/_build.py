"""Build the CUDA kernels in `csrc/` with nvcc and bind them with ctypes.

The sources compile, on their first use in a process, into one shared
library with a plain C interface: one nvcc per source, all started
together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <src>.o csrc/<src>.cu       # each, at once
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libbnn_kernels_<hash>.so *.o

The library lands in `bnn_pynq_tpu_torch/_build/` (git-ignored), named by
a hash of the sources and flags, so an edited source builds anew and an
unchanged one loads at once. nvcc is `$CUDA_HOME/bin/nvcc`, else the
one on PATH, else `/usr/local/cuda/bin/nvcc`. A failed build raises with
nvcc's output. Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of every exported function: c_void_p for pointers (device and
# host) and the stream, c_int for ints. Each
# returns a cudaError_t as int, or DECLINED.
_SIGNATURES = {
    # x, m, k0, w_ptrs, wsum_ptrs, thr_ptrs, k32, n, n_layers, nthr, abits,
    # input_levels, scale, bias, out, stream
    "bnn_fused_mlp": (_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                      _P, _P, _P),
    # x, m, k0, input_levels, wt, k32, n_out, wsum, thr, nthr, abits, out,
    # stream
    "bnn_dense_block": (_P, _I, _I, _I, _P, _I, _I, _P, _P, _I, _I, _P,
                        _P),
    # rows, m, k0, x2, h2, w2, c2, stride, oh, ow, projection, r, wt, k32,
    # n_out, thr, nthr, out, stream
    "bnn_dense_residual": (_P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                           _P, _I, _I, _P, _I, _P, _P),
    # x, b, h, w, c, ksize, input_levels, wt, k32, n_out, wsum, thr, nthr,
    # abits, pool, out, stream
    "bnn_conv_layer": (_P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I,
                       _I, _I, _P, _P),
    # x, b, h, w, c, stride, wt, thr, nthr, abits, out, stream
    "bnn_dw_conv": (_P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P),
    # a, m, kw, w, n, k, bits, popc, thr, nthr, out, stream
    "bnn_packed_matmul": (_P, _I, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P),
    # x, b, h, w, c, ksize, wt, tiles, k32, n_out, wsum, thr, nthr, abits,
    # input_levels, out, stream
    "bnn_conv_direct": (_P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I,
                        _I, _I, _P, _P),
    # x, b, h, w, c, ksize, input_levels, w_ptrs, k32s, n_outs, wsum_ptrs,
    # thr_ptrs, n_layers, nthr, abits, out, stream
    "bnn_conv_chain_direct": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                              _P, _I, _I, _I, _P, _P),
    # the Mosaic probes (csrc/mosaic_probes.cu)
    # x, m, c, w, taps, n, out, stream
    "bnn_probe_lane_concat": (_P, _I, _I, _P, _I, _I, _P, _P),
    "bnn_probe_scratch_lane_store": (_P, _I, _I, _P, _I, _I, _P, _P),
    # x, rows, c, out, stream
    "bnn_probe_mid_dim_index": (_P, _I, _I, _P, _P),
    # x, bb, h, w, c, out, stream
    "bnn_probe_pool_reshape_max": (_P, _I, _I, _I, _I, _P, _P),
    # x, rows_in, c, stride, out, stream
    "bnn_probe_strided_row_slice": (_P, _I, _I, _I, _P, _P),
    # x, m, n, lo, width, out, stream
    "bnn_probe_lane_slice_64": (_P, _I, _I, _I, _I, _P, _P),
    # x, rows, group, c, out, stream
    "bnn_probe_int32_acc_reshape": (_P, _I, _I, _I, _P, _P),
}

DECLINED = -1     # no cudaError_t: csrc/conv_direct.cu kChainNoImageFits


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float      # 0.0 when an existing build was loaded
    build_log: str            # nvcc's output (ptxas register/smem report)

    def call(self, name: str, *args, may_decline: bool = False) -> bool:
        """Call an exported launcher; raise if it returns a CUDA error.
        True if it launched; False if it answered DECLINED (the shape is
        another kernel's, nothing was launched), which only a caller that
        says `may_decline` accepts."""
        rc = getattr(self.lib, name)(*args)
        if rc == DECLINED and may_decline:
            return False
        if rc != 0:
            msg = self.lib.bnn_error_string(rc).decode()
            raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
        return True


@contextlib.contextmanager
def gc_paused() -> Iterator[None]:
    """No cyclic garbage collection inside the block, in any thread; put
    around every CUDA graph capture. A collection there can free another
    program's graph (an engine and its programs form a cycle), and
    destroying a graph is a call a capture forbids: it invalidates the
    capture (cudaErrorStreamCaptureInvalidated)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class LaunchCounter:
    """How many times a wrapper launched its kernel (thread-safe)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


_lock = threading.Lock()
_library = None


def library() -> KernelLibrary:
    """The kernel library, built on first use (once per process)."""
    global _library
    with _lock:
        if _library is None:
            _library = _load()
        return _library


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + \
        [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source on first use")


def _run(cmds) -> str:
    """Run nvcc commands in parallel; raise with the output of a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _load() -> KernelLibrary:
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    path = BUILD_DIR / f"libbnn_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        srcs = sorted(CSRC_DIR.glob("*.cu"))
        objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
        t0 = time.perf_counter()
        try:
            log = _run([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)])
            log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                          *[str(o) for o in objs]]])
        except RuntimeError:
            tmp.unlink(missing_ok=True)
            raise
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        os.replace(tmp, path)     # atomic: a concurrent loader sees all or none
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.bnn_error_string.argtypes = [ctypes.c_int]
    lib.bnn_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds,
                         build_log=log)


def pointer_array(tensors) -> ctypes.Array:
    """Host array of device pointers (None → NULL) for a launcher."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)
