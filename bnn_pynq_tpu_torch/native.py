"""Host image ops: the host half of the reference's `binarizeAndPack`,
and the Classifier's preprocessing.

Port of `bnn_pynq_tpu/native.py` (`build`, `binarize_pack`,
`center_int8`, `pack_bits`, `pack_codes2`, `argmax`, `resize_nn`). Where
the repo's framework-neutral C++ library `native/libbnn_host.so` has been
built (`build()`, which runs `make -C native`), it is bound with ctypes;
otherwise the numpy bodies run. The two are bit-identical (the JAX package's `tests/test_native.py`
holds the library to numpy). The packers return uint32 words;
`ops.packing.words_to_tensor` views them as int32 for torch.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from bnn_pynq_tpu_torch.ops.packing import (np_pack_bits, np_pack_codes2,
                                            packed_len)

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libbnn_host.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None and os.path.exists(_LIB_PATH):
            lib = ctypes.CDLL(_LIB_PATH)
            c_i64 = ctypes.c_int64
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.bnn_binarize_pack_u8.argtypes = [u8p, u32p, c_i64, c_i64,
                                                 ctypes.c_uint8]
            lib.bnn_center_int8.argtypes = [u8p, i8p, c_i64]
            lib.bnn_pack_bits_i8.argtypes = [i8p, u32p, c_i64, c_i64]
            lib.bnn_pack_codes2_i8.argtypes = [i8p, u32p, c_i64, c_i64]
            lib.bnn_argmax_f32.argtypes = [f32p, c_i64, c_i64, i32p]
            lib.bnn_resize_nn_u8.argtypes = [u8p, u8p] + [c_i64] * 6
            for fn in (lib.bnn_binarize_pack_u8, lib.bnn_center_int8,
                       lib.bnn_pack_bits_i8, lib.bnn_pack_codes2_i8,
                       lib.bnn_argmax_f32, lib.bnn_resize_nn_u8):
                fn.restype = None
            _lib = lib
        return _lib


def build(quiet: bool = True) -> bool:
    """Build the C++ library in-tree (`make -C native`) and bind it anew;
    returns whether it is bound."""
    global _lib
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=quiet)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    with _lock:
        _lib = None
    return _try_load() is not None


def available() -> bool:
    """Whether the C++ library is bound (else the numpy bodies run)."""
    return _try_load() is not None


def binarize_pack(imgs: np.ndarray, thresh: int = 128) -> np.ndarray:
    """uint8 [N, ...] → packed bipolar uint32 [N, ceil(len/32)]; the bit is
    pixel >= thresh."""
    imgs = np.ascontiguousarray(imgs.reshape(imgs.shape[0], -1),
                                dtype=np.uint8)
    n, length = imgs.shape
    words = packed_len(length, 1)
    lib = _try_load()
    if lib is None:
        bits = (imgs >= thresh)
        pad = words * 32 - length
        if pad:
            bits = np.pad(bits, ((0, 0), (0, pad)))
        return (bits.reshape(n, words, 32).astype(np.uint32)
                << np.arange(32, dtype=np.uint32)).sum(-1).astype(np.uint32)
    out = np.empty((n, words), dtype=np.uint32)
    lib.bnn_binarize_pack_u8(imgs, out, n, length, thresh)
    return out


def center_int8(imgs: np.ndarray) -> np.ndarray:
    """uint8 → int8 (x - 128), shape-preserving."""
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    lib = _try_load()
    if lib is None:
        return (imgs.astype(np.int32) - 128).astype(np.int8)
    out = np.empty(imgs.shape, dtype=np.int8)
    lib.bnn_center_int8(imgs.reshape(-1), out.reshape(-1), imgs.size)
    return out


def pack_bits(vals: np.ndarray) -> np.ndarray:
    """±1 int8 [R, K] → uint32 [R, ceil(K/32)] (bit = v > 0)."""
    vals = np.ascontiguousarray(vals, dtype=np.int8)
    r, k = vals.shape
    lib = _try_load()
    if lib is None:
        return np_pack_bits(vals, axis=-1)
    out = np.empty((r, packed_len(k, 1)), dtype=np.uint32)
    lib.bnn_pack_bits_i8(vals, out, r, k)
    return out


def pack_codes2(codes: np.ndarray) -> np.ndarray:
    """2-bit codes int8 [R, K] → uint32 [R, ceil(K/16)]."""
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    r, k = codes.shape
    lib = _try_load()
    if lib is None:
        return np_pack_codes2(codes, axis=-1)
    out = np.empty((r, packed_len(k, 2)), dtype=np.uint32)
    lib.bnn_pack_codes2_i8(codes, out, r, k)
    return out


def argmax(logits: np.ndarray) -> np.ndarray:
    """Row-wise argmax of float32 logits [N, ncls] → int32 [N]."""
    logits = np.ascontiguousarray(logits, dtype=np.float32)
    n, ncls = logits.shape
    lib = _try_load()
    if lib is None:
        return logits.argmax(-1).astype(np.int32)
    out = np.empty(n, dtype=np.int32)
    lib.bnn_argmax_f32(logits, n, ncls, out)
    return out


def resize_nn(imgs: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Nearest-neighbour resize uint8 [N, H, W, C] → [N, oh, ow, C]."""
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    n, h, w, c = imgs.shape
    lib = _try_load()
    if lib is None:
        ys = np.minimum(h - 1, np.arange(oh) * h // oh)
        xs = np.minimum(w - 1, np.arange(ow) * w // ow)
        return imgs[:, ys][:, :, xs]
    out = np.empty((n, oh, ow, c), dtype=np.uint8)
    lib.bnn_resize_nn_u8(imgs.reshape(-1), out.reshape(-1), n, h, w, c,
                         oh, ow)
    return out
