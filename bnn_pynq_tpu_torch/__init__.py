"""bnn_pynq_tpu_torch — the PyTorch/CUDA port of bnn_pynq_tpu.

The JAX package `bnn_pynq_tpu` is the reference; this package computes the
same integer inference with PyTorch tensors and hand-written CUDA kernels
for Hopper (sm_90a). It never imports `jax` or `bnn_pynq_tpu`: the few
framework-neutral pieces it needs (network configs, the artifact loader,
bit packing and the host packers) are copied, because importing any
`bnn_pynq_tpu` submodule runs that package's `__init__`, which imports
`jax.numpy`.

The integer conventions are the reference's (see `bnn_pynq_tpu/__init__.py`):
1-bit value v = 2b - 1, 2-bit level q = 2c - 3, and MultiThreshold codes
code = Σ_t (acc >= thr[t]).

Importing this package imports nothing heavy; kernels are built with
`nvcc` on their first launch (ops/_build.py).
"""

__version__ = "0.1.0"
