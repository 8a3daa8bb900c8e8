"""Dataset loading: real data from local .npz files, else a deterministic
synthetic set (flagged `synthetic`), so that evaluation runs end to end
without downloads.

Copied from `bnn_pynq_tpu/train/data.py` (numpy only; the port never
imports the JAX package).

Real-data format: `<search_dir>/<name>.npz` with uint8 `x_train` `x_test`
(NHWC or N×784) and integer `y_train` `y_test`.
Search dirs: $BNN_DATA_DIR, ./data, ~/.cache/bnn_pynq_tpu.

Preprocessing conventions (must match the inference engine exactly):
- MNIST (bipolar nets): pixel >= 128 → +1 else -1  (784-dim ±1 vector).
- Image nets (CNV): int8 value = uint8 - 128; float input = int8 / 128.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass

import numpy as np

_SHAPES = {
    "mnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
    "svhn": (32, 32, 3),
    "gtsrb": (32, 32, 3),
}
_CLASSES = {"mnist": 10, "cifar10": 10, "svhn": 10, "gtsrb": 43}

CIFAR10_CLASSES = ("airplane", "automobile", "bird", "cat", "deer", "dog",
                   "frog", "horse", "ship", "truck")


@dataclass
class Dataset:
    name: str
    x_train: np.ndarray   # uint8
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    synthetic: bool

    @property
    def num_classes(self) -> int:
        return _CLASSES[self.name]


def _search_dirs():
    dirs = []
    if os.environ.get("BNN_DATA_DIR"):
        dirs.append(os.environ["BNN_DATA_DIR"])
    dirs.append(os.path.join(os.getcwd(), "data"))
    dirs.append(os.path.expanduser("~/.cache/bnn_pynq_tpu"))
    return dirs


def load(name: str, synthetic_sizes=(4096, 1024)) -> Dataset:
    name = name.lower()
    if name not in _SHAPES:
        raise KeyError(f"unknown dataset {name}")
    for d in _search_dirs():
        path = os.path.join(d, f"{name}.npz")
        if os.path.exists(path):
            z = np.load(path)
            return Dataset(name, z["x_train"], z["y_train"].astype(np.int32),
                           z["x_test"], z["y_test"].astype(np.int32),
                           synthetic=False)
    return _synthetic(name, *synthetic_sizes)


def _synthetic(name: str, n_train: int, n_test: int) -> Dataset:
    """Deterministic learnable synthetic data: class-dependent template +
    noise, uint8, same shape/range as the real dataset."""
    shape = _SHAPES[name]
    ncls = _CLASSES[name]
    # zlib.crc32 is stable across processes (Python salts str hash per
    # process, which made "deterministic" synthetic data irreproducible).
    rng = np.random.default_rng(zlib.crc32(name.encode()) % (2 ** 31))
    templates = rng.integers(0, 256, size=(ncls,) + shape)

    def make(n, seed):
        r = np.random.default_rng(seed)
        y = r.integers(0, ncls, size=n).astype(np.int32)
        noise = r.normal(0, 64, size=(n,) + shape)
        x = np.clip(templates[y] * 0.6 + noise + 50, 0, 255).astype(np.uint8)
        return x, y

    x_train, y_train = make(n_train, 1)
    x_test, y_test = make(n_test, 2)
    return Dataset(name, x_train, y_train, x_test, y_test, synthetic=True)


def to_bipolar(x_uint8: np.ndarray) -> np.ndarray:
    """MNIST-style binarized input: ±1 float32, flattened."""
    flat = x_uint8.reshape(x_uint8.shape[0], -1)
    return np.where(flat >= 128, 1.0, -1.0).astype(np.float32)


def to_int8(x_uint8: np.ndarray) -> np.ndarray:
    """Image input for the integer engine: int8 = uint8 - 128."""
    return (x_uint8.astype(np.int32) - 128).astype(np.int8)


def to_float(x_uint8: np.ndarray) -> np.ndarray:
    """Image input for float training: int8/128 ∈ [-1, 1)."""
    return to_int8(x_uint8).astype(np.float32) / 128.0


def train_inputs(name: str, x_uint8: np.ndarray, input_kind: str) -> np.ndarray:
    if input_kind == "bipolar":
        return to_bipolar(x_uint8)
    return to_float(x_uint8)
