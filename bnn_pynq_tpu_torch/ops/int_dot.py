"""Exact integer dots and convolutions through the vendor libraries: what
the JAX package's decoded-integer route computes with XLA's int8 dots and
bf16 convs, outside any Pallas kernel (`bnn_pynq_tpu/models/network.py::
forward_xla`).

- `int_matmul`: int8 × int8 → int32 through `torch._int_mm`, cuBLASLt's
  int8 GEMM on a card and the CPU's int8 GEMM here; exact, the
  accumulator is int32.
- `int_conv2d`: a VALID integer conv through `F.conv2d` on float64
  operands (cuDNN on a card), rounded to int32; exact by the argument in
  its docstring.

Each counts its calls in `.calls` (the engine's `library_calls()` reads
them). Neither is a hand-written kernel: the port's own kernels are the
`mega`, packed and `direct` routes'.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F

from bnn_pynq_tpu_torch.ops._build import LaunchCounter

# torch._int_mm on a card takes more than 16 rows, and K and N in
# multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def k_contiguous(w: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] → the same values stored K-contiguous (column-major),
    the layout of both operands that cuBLASLt's int8 GEMM takes (its
    "TN" form; a row-major [K, N] operand is refused)."""
    return w.t().contiguous().t()


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a int8 [M, K] · w int8 [K, N] → int32 [M, N], exact.

    Both operands go in K-contiguous; w costs no copy when it already is
    (`k_contiguous`, as `decode_params` stores it) and needs no padding.
    K is zero-padded to a multiple of 8 on both operands (a zero level adds
    nothing to the dot), N on w, and M up to 17 rows; the result is sliced
    back to [M, N]. The same padding runs on every device, so the CPU runs
    the code the card runs."""
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int_matmul takes int8 operands, got {a.dtype} and "
                        f"{w.dtype}")
    m, k = a.shape
    n = w.shape[1]
    kp, np_ = _round_up(k, _ALIGN), _round_up(n, _ALIGN)
    wt = w.t()                                  # [N, K]
    if kp != k or np_ != n:
        wt = F.pad(wt, (0, kp - k, 0, np_ - n))
    if kp != k:
        a = F.pad(a, (0, kp - k))
    if m < _MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _MIN_ROWS - m))
    int_matmul.calls.add()
    return torch._int_mm(a.contiguous(), wt.contiguous().t())[:m, :n]


int_matmul.calls = LaunchCounter()


@contextlib.contextmanager
def _heuristic_algorithm() -> Iterator[None]:
    """cuDNN's algorithm chosen by its heuristics, not by timing runs
    (benchmark off), so an eager run and a CUDA graph capture of the same
    shape choose the same one."""
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = benchmark


def int_conv2d(vals: torch.Tensor, w_hwio: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """Exact integer VALID conv: vals int8 [B, H, W, C] · w_hwio int8
    [kh, kw, C, O] → int32 [B, OH, OW, O], through the library's float64
    convolution (cuDNN on a card), channels-last, rounded to int32.

    The counterpart of JAX's `_conv_bf16_exact`, which is exact because
    the MXU sums bf16 products of small integers in float32. Here neither
    bf16 nor float32 will do. PyTorch's bf16 conv returns bf16, which
    rounds any sum above 256. A float32 conv would be exact if cuDNN
    multiplied operands and added products (direct or implicit GEMM):
    every partial sum is an integer of magnitude ≤ Σ|a·w| ≤
    K·max|a|·max|w| (|activation| ≤ 128 on an 8-bit first conv, ≤ 3 after
    it; |weight| ≤ 3), at most 20,736 on CNV (W2A2's K = 2304 conv; the
    first conv's 27 × 128 × 3 = 10,368), below 2^24. But cuDNN's
    heuristics pick an FFT algorithm for some of CNV's float32 convs on an
    H100, whose transforms leave each output off its integer by a rounding
    error, rounded away only while it stays below 0.5, which float32's
    24 bits do not guarantee for sums up to 2^15.

    Float64 gives the margin: every operand is an integer, exactly a
    float64; an algorithm that multiplies and adds holds every partial
    sum (< 2^15) exactly, being far below 2^53; and one that transforms
    (FFT, Winograd) errs by at most a modest multiple of the unit
    roundoff 2^-53 times the operands' magnitudes (≤ 2^15 a sum; even
    an error growth of 2^30 leaves 2^-8 < 0.5), so rounding to the
    nearest integer gives the exact sum whatever algorithm runs."""
    if vals.dtype != torch.int8 or w_hwio.dtype != torch.int8:
        raise TypeError(f"int_conv2d takes int8 operands, got {vals.dtype} "
                        f"and {w_hwio.dtype}")
    x = vals.permute(0, 3, 1, 2).to(torch.float64).contiguous(
        memory_format=torch.channels_last)
    w = w_hwio.permute(3, 2, 0, 1).to(torch.float64).contiguous(
        memory_format=torch.channels_last)
    int_conv2d.calls.add()
    with _heuristic_algorithm():
        acc = F.conv2d(x, w, stride=stride)
    return acc.permute(0, 2, 3, 1).round_().to(torch.int32)


int_conv2d.calls = LaunchCounter()
