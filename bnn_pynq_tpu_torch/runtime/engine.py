"""Inference engine on PyTorch tensors.

Port of `bnn_pynq_tpu/runtime/engine.py::InferenceEngine`: loads a
CompiledNetwork's integer parameters onto one device once and serves
classifications, padding batches to fixed buckets.

Runtimes:
- 'kernels': the kernel route (models/network.py::forward_mega) — the CUDA
  kernels on a CUDA device, their plain versions on the CPU.
- 'ref':     the reference forward (models/network.py::forward_ref).

A CUDA engine never runs on the CPU: `device="cuda"` without CUDA raises.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bnn_pynq_tpu_torch.compiler.artifacts import (CompiledNetwork,
                                                   load_artifact)
from bnn_pynq_tpu_torch.models.config import NetworkConfig
from bnn_pynq_tpu_torch.models.network import (forward_mega, forward_ref,
                                               input_shape)
from bnn_pynq_tpu_torch.models.params import Params, params_from_numpy

DEFAULT_BATCH_BUCKETS = (1, 16, 64, 256, 1024)
RUNTIMES = ("kernels", "ref")


def prepare_host(config: NetworkConfig, x: np.ndarray) -> np.ndarray:
    """uint8 images → engine input: binarized ±1 for bipolar nets, centred
    int8 for image nets (the host half of the reference's
    `binarizeAndPack`)."""
    x = np.asarray(x)
    if config.input_kind == "bipolar":
        flat = x.reshape(x.shape[0], -1)
        if x.dtype == np.uint8:
            return np.where(flat >= 128, 1, -1).astype(np.int8)
        return np.where(flat >= 0, 1, -1).astype(np.int8)
    if x.dtype == np.uint8:
        return (x.astype(np.int32) - 128).astype(np.int8)
    return x.astype(np.int8)


class InferenceEngine:
    """Loads a CompiledNetwork onto a device and serves classifications."""

    def __init__(self, compiled: CompiledNetwork, *, device="cuda",
                 runtime: str = "kernels",
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS):
        if runtime not in RUNTIMES:
            raise ValueError(f"unknown runtime {runtime!r}; one of "
                             f"{RUNTIMES}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available; "
                               "pass device='cpu' to run the plain versions")
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        self.config: NetworkConfig = compiled.config
        self.compiled = compiled
        self.device = device
        self.runtime = runtime
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.usecPerImage: Optional[float] = None
        # (layers, out_scale, out_bias), published and read as one unit
        self._state: Params = params_from_numpy(
            self.config, compiled.layers, compiled.out_scale,
            compiled.out_bias, device)

    def load_parameters(self, compiled: CompiledNetwork):
        """Hot-swap parameters of the same topology. The new parameters
        are published by one assignment, and every launch reads that
        tuple once, so a batch never mixes old and new parameters."""
        if compiled.config.layers != self.config.layers or \
                compiled.config.wbits != self.config.wbits or \
                compiled.config.abits != self.config.abits:
            raise ValueError("parameter topology mismatch; build a new "
                             "engine for a different network")
        state = params_from_numpy(self.config, compiled.layers,
                                  compiled.out_scale, compiled.out_bias,
                                  self.device)
        self._state = state
        self.compiled = compiled
        return self

    # -- input preparation ------------------------------------------------
    def prepare(self, x: np.ndarray) -> np.ndarray:
        return prepare_host(self.config, x)

    def _bucket(self, b: int) -> int:
        for s in self.batch_buckets:
            if b <= s:
                return s
        return -(-b // self.batch_buckets[-1]) * self.batch_buckets[-1]

    def _pad_to_bucket(self, x: np.ndarray):
        """Pad a leading-batch array up to the next bucket size; returns
        (padded, true_batch)."""
        b = x.shape[0]
        bucket = self._bucket(b)
        if bucket != b:
            pad = np.zeros((bucket - b,) + x.shape[1:], dtype=x.dtype)
            x = np.concatenate([x, pad], axis=0)
        return x, b

    # -- inference --------------------------------------------------------
    def _launch(self, x: np.ndarray, argmax: bool) -> torch.Tensor:
        """Run one padded, prepared batch; returns the device output
        without waiting for it."""
        xt = torch.from_numpy(np.require(x, requirements=("C", "W")))
        xt = xt.to(self.device)
        layers, out_scale, out_bias = self._state
        if self.runtime == "kernels":
            out = forward_mega(self.config, layers, xt, out_scale, out_bias)
        else:
            out = forward_ref(self.config, layers, xt).to(torch.float32) \
                * out_scale + out_bias
        if argmax:
            out = out.argmax(dim=-1).to(torch.int32)
        return out

    def fetch(self, dev_out: torch.Tensor) -> np.ndarray:
        """Device output → numpy (waits for the device)."""
        return dev_out.cpu().numpy()

    def logits_device(self, x: np.ndarray, *, prepared: bool = False,
                      argmax: bool = False) -> Tuple[torch.Tensor, int]:
        """Launch without fetching: returns (device_out, true_batch).
        argmax=True gives int32 class indices computed on the device."""
        if not prepared:
            x = self.prepare(x)
        x, b = self._pad_to_bucket(x)
        return self._launch(x, argmax), b

    def _run(self, x: np.ndarray, prepared: bool, argmax: bool):
        if not prepared:
            x = self.prepare(x)
        x, b = self._pad_to_bucket(x)
        t0 = time.perf_counter()
        out = self.fetch(self._launch(x, argmax))
        self.usecPerImage = (time.perf_counter() - t0) * 1e6 / b
        return out[:b]

    def logits(self, x: np.ndarray, *, prepared: bool = False) -> np.ndarray:
        """Float logits [B, num_classes]."""
        return self._run(x, prepared, argmax=False)

    def classify(self, x: np.ndarray, *, prepared: bool = False) -> np.ndarray:
        """Class indices [B] (int32); the argmax runs on the device."""
        return self._run(x, prepared, argmax=True)

    def classify_one(self, image: np.ndarray) -> int:
        return int(self.classify(image[None])[0])

    def warmup(self, batch: int = 1):
        """Run both programs once at `batch`'s bucket: builds the kernels
        (first use in the process) before live traffic."""
        dummy = np.zeros(input_shape(self.config, batch), dtype=np.int8)
        self.logits(dummy, prepared=True)
        self.classify(dummy, prepared=True)
        return self

    @classmethod
    def from_artifact(cls, path: str, **kw) -> "InferenceEngine":
        return cls(load_artifact(path), **kw)
