"""Quantized matmul on bit-packed operands with a fused MultiThreshold.

Port of `bnn_pynq_tpu/ops/matmul.py::packed_matmul` (and `_padded`), the
MVTU of every binary and 2-bit conv and dense layer on the packed routes.
Both operands are packed along K with the same width `bits` (see
ops/packing.py): 1 for W1A1, else 2 (±1 weights of a W1A2 layer are
stored as codes 1/2). Pad positions are zero bits in both operands.

Routes, all exact and equal to each other:
- 'vpu' (bits=1 only): XNOR-popcount, ``acc = k - 2·Σ popc(a XOR w)``;
  the pad bits agree, so they drop out.
- 'mxu' / 'mxu_rm': decode both operands to int8 levels (2b−1, or 2c−3),
  an exact int32 dot, minus the pad term ``n_pad·padval²`` (+1 per pad
  position for bits=1, +9 for bits=2). On the TPU the two are layout
  arms (transposed vs row-major activations); here one CUDA entry serves
  both, and each keeps its own launch count.

With `thr` int32 [nthr, N] the result is the int8 code
``Σ_t (acc >= thr[t])``; without it, the int32 `acc`.

The CUDA kernel is `csrc/packed_matmul.cu` (entry `bnn_packed_matmul`),
on the tensor cores: 'vpu' runs the 1-bit `mma.sync.m16n8k256` with
`.and.popc` on the packed words as they lie in memory (popc(a XOR w) =
popc(a) + popc(w) − 2·popc(a AND w), the row and column counts taken in
the kernel), 'mxu' / 'mxu_rm' decode the weights to int8 levels once a
block, in shared memory, and the activations in registers, and run the
int8 `mma.sync.m16n8k32`. It takes any M and N, so the TPU's tiling limits
(M, N divisible by the block) are gone and `packed_matmul_padded` pads
nothing; it takes any K as well: where a block's shared memory cannot hold
whole rows of K (beyond about 13,000 1-bit or 9,000 2-bit levels on the
decode arm, 24,000 bits on 'vpu') the same kernel body walks K in slices
with the accumulators kept across them. A CPU tensor runs the plain version;
a CUDA tensor launches the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from bnn_pynq_tpu_torch.ops import _build
from bnn_pynq_tpu_torch.ops.packing import (codes2_to_levels, packed_len,
                                            unpack_bits, unpack_codes2)
from bnn_pynq_tpu_torch.ops.ref import int_matmul_ref
from bnn_pynq_tpu_torch.ops.thresholds import multithreshold

ROUTES = ("mxu", "mxu_rm", "vpu")
MAX_THR = 3          # csrc/packed_matmul.cu kMaxThr


def unpack_levels(words: torch.Tensor, k: int, bits: int,
                  axis: int) -> torch.Tensor:
    """int32 words packed along `axis` → int8 levels, `axis` cut to k."""
    if bits == 1:
        return unpack_bits(words, k, axis=axis)
    return codes2_to_levels(unpack_codes2(words, k, axis=axis))


def packed_matmul_plain(a_words, w_words, thr=None, *, k: int, bits: int,
                        route: str = "mxu") -> torch.Tensor:
    """Plain PyTorch version of `packed_matmul` (same arguments): unpack
    both operands to levels, exact int matmul, then thresholds. Every
    route computes this."""
    acc = int_matmul_ref(unpack_levels(a_words, k, bits, axis=-1),
                         unpack_levels(w_words, k, bits, axis=0))
    return acc if thr is None else multithreshold(acc, thr)


def _check(a_words, w_words, thr, k, bits, route) -> None:
    for name, t in (("a_words", a_words), ("w_words", w_words)):
        if t.dtype != torch.int32 or t.ndim != 2:
            raise ValueError(f"{name} must be int32 words [.., ..], got "
                             f"{t.dtype} {tuple(t.shape)}")
    m, kw = a_words.shape
    kw2, n = w_words.shape
    if kw != kw2:
        raise ValueError(f"packed K mismatch: {kw} vs {kw2}")
    if bits not in (1, 2):
        raise ValueError(f"unsupported packing width bits={bits}")
    if packed_len(k, bits) != kw:
        raise ValueError(f"k={k} bits={bits} implies Kw={packed_len(k, bits)}"
                         f" but operands have Kw={kw}")
    if route == "vpu" and bits != 1:
        raise ValueError("route='vpu' (XNOR popcount) requires bits=1")
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}")
    if thr is not None and (thr.dtype != torch.int32 or thr.ndim != 2
                            or thr.shape[1] != n
                            or not 1 <= thr.shape[0] <= MAX_THR):
        raise ValueError(f"thr must be int32 [1..{MAX_THR}, {n}], got "
                         f"{thr.dtype} {tuple(thr.shape)}")


def packed_matmul(a_words: torch.Tensor, w_words: torch.Tensor,
                  thr: Optional[torch.Tensor] = None, *, k: int,
                  bits: int = 1, route: str = "mxu") -> torch.Tensor:
    """Quantized matmul on packed operands.

    a_words: int32 [M, Kw] words packed along K; w_words: int32 [Kw, N]
    packed along K; thr: int32 [nthr, N] ascending, or None; k: the true
    (unpadded) K. Returns int8 codes [M, N] with thr, else int32 [M, N].
    """
    _check(a_words, w_words, thr, k, bits, route)
    if a_words.device.type == "cpu":
        return packed_matmul_plain(a_words, w_words, thr, k=k, bits=bits,
                                   route=route)
    for t in [a_words, w_words] + ([thr] if thr is not None else []):
        if t.device.type != "cuda" or t.device != a_words.device:
            raise ValueError(f"no kernel for device {t.device}; tensors "
                             "must all be on the CPU (plain version) or on "
                             "one CUDA device")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    m, kw = a_words.shape
    n = w_words.shape[1]
    out = torch.empty((m, n), dtype=torch.int8 if thr is not None
                      else torch.int32, device=a_words.device)
    _build.library().call(
        "bnn_packed_matmul", a_words.data_ptr(), m, kw, w_words.data_ptr(),
        n, k, bits, int(route == "vpu"),
        None if thr is None else thr.data_ptr(),
        0 if thr is None else thr.shape[0], out.data_ptr(),
        torch.cuda.current_stream(a_words.device).cuda_stream)
    packed_matmul.launches[route].add()
    return out


# one count per arm: 'mxu' and 'mxu_rm' launch the same CUDA entry
packed_matmul.launches = {r: _build.LaunchCounter() for r in ROUTES}

# The JAX `_padded` form pads M to its block and limits N; the kernel
# masks both edges itself, so here it is the same function.
packed_matmul_padded = packed_matmul
