"""Bit packing / unpacking for binarized and 2-bit quantized tensors.

Port of `bnn_pynq_tpu/ops/packing.py`. Values are packed 32 per word along
one axis:
- 1-bit: value v ∈ {-1,+1} (or a {0,1} code), bit b = (v > 0); bit j of
  word w holds element 32w+j.
- 2-bit: code c ∈ {0..3} (integer level 2c-3); 16 codes per word, code j
  at bits [2j, 2j+2).
- Padding: the axis is padded up to a whole word with zero bits (value -1
  for 1-bit, code 0 for 2-bit). Consumers correct for the pad.

Words are **int32 tensors holding the uint32 bit pattern** (the host's
uint32 arrays enter through `ndarray.view(np.int32)`): torch has no right
shift for uint32 on the CPU. Unpacking uses an arithmetic `>>` on int32
followed by a mask, which is exact for bit 31 too. Packing sums the
shifted bits in int64 and wraps the sum to the int32 bit pattern, so bit
31 never overflows a signed sum.

`np_pack_bits` / `np_pack_codes2` are the numpy packers (uint32 out), as
in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def packed_len(n: int, bits: int = 1) -> int:
    """Number of 32-bit words needed to hold `n` values of width `bits`."""
    per_word = WORD_BITS // bits
    return -(-n // per_word)


def pad_amount(n: int, bits: int = 1) -> int:
    """How many pad elements are appended when packing `n` values."""
    per_word = WORD_BITS // bits
    return packed_len(n, bits) * per_word - n


def _pack(fields: torch.Tensor, axis: int, bits: int) -> torch.Tensor:
    """Pack int64 fields (each < 2^bits) along `axis` into int32 words."""
    moved = fields.movedim(axis, -1)
    pad = pad_amount(moved.shape[-1], bits)
    if pad:
        moved = torch.nn.functional.pad(moved, (0, pad))
    per_word = WORD_BITS // bits
    words = moved.reshape(moved.shape[:-1] + (-1, per_word))
    shifts = bits * torch.arange(per_word, dtype=torch.int64,
                                 device=fields.device)
    total = (words << shifts).sum(dim=-1)          # int64, < 2^32
    wrapped = torch.where(total >= 2 ** 31, total - 2 ** 32, total)
    return wrapped.to(torch.int32).movedim(-1, axis)


def _unpack(packed: torch.Tensor, n: int, axis: int,
            bits: int) -> torch.Tensor:
    """int32 words → int8 fields (each < 2^bits), `axis` cut to `n`."""
    if packed.dtype != torch.int32:
        raise TypeError(f"packed words are int32, got {packed.dtype}")
    moved = packed.movedim(axis, -1)
    per_word = WORD_BITS // bits
    shifts = bits * torch.arange(per_word, dtype=torch.int32,
                                 device=packed.device)
    fields = (moved[..., None] >> shifts) & ((1 << bits) - 1)
    flat = fields.reshape(fields.shape[:-2] + (-1,))[..., :n]
    return flat.to(torch.int8).movedim(-1, axis)


def pack_bits(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack ±1 (or {0,1}) values into int32 words along `axis`; the packed
    bit is ``x > 0``. `axis` shrinks to ``packed_len(n, 1)``."""
    return _pack((x > 0).to(torch.int64), axis, 1)


def unpack_bits(packed: torch.Tensor, n: int, axis: int = -1) -> torch.Tensor:
    """Inverse of `pack_bits`: int32 words → int8 values in {-1,+1}; `n` is
    the true (unpadded) element count along `axis`."""
    return (2 * _unpack(packed, n, axis, 1) - 1).to(torch.int8)


def pack_codes2(codes: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack 2-bit codes {0..3} into int32 words (16 per word) along `axis`."""
    return _pack(codes.to(torch.int64) & 3, axis, 2)


def unpack_codes2(packed: torch.Tensor, n: int,
                  axis: int = -1) -> torch.Tensor:
    """Inverse of `pack_codes2`: → int8 codes in {0..3}."""
    return _unpack(packed, n, axis, 2)


def codes2_to_levels(codes: torch.Tensor) -> torch.Tensor:
    """2-bit codes {0..3} → odd integer levels {-3,-1,+1,+3} (int8)."""
    return (2 * codes.to(torch.int8) - 3).to(torch.int8)


def levels_to_codes2(levels: torch.Tensor) -> torch.Tensor:
    """Odd integer levels {-3,-1,+1,+3} → codes {0..3} (int8)."""
    return torch.div(levels.to(torch.int8) + 3, 2,
                     rounding_mode="floor").to(torch.int8)


# ---------------------------------------------------------------------------
# Host-side numpy packers (uint32 words), copies of the JAX module's.
# ---------------------------------------------------------------------------

def np_pack_bits(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = np.asarray(x)
    moved = np.moveaxis(x, axis % x.ndim, -1)
    n = moved.shape[-1]
    pad = pad_amount(n, 1)
    bits = (moved > 0).astype(np.uint32)
    if pad:
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    words = bits.reshape(bits.shape[:-1] + (-1, WORD_BITS))
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    packed = (words << shifts).sum(axis=-1).astype(np.uint32)
    return np.moveaxis(packed, -1, axis % x.ndim)


def np_pack_codes2(codes: np.ndarray, axis: int = -1) -> np.ndarray:
    codes = np.asarray(codes)
    moved = np.moveaxis(codes, axis % codes.ndim, -1)
    n = moved.shape[-1]
    per_word = WORD_BITS // 2
    pad = pad_amount(n, 2)
    c = (moved.astype(np.uint32)) & np.uint32(3)
    if pad:
        c = np.pad(c, [(0, 0)] * (c.ndim - 1) + [(0, pad)])
    words = c.reshape(c.shape[:-1] + (-1, per_word))
    shifts = (2 * np.arange(per_word, dtype=np.uint32)).astype(np.uint32)
    packed = (words << shifts).sum(axis=-1).astype(np.uint32)
    return np.moveaxis(packed, -1, axis % codes.ndim)


def words_to_tensor(words: np.ndarray) -> torch.Tensor:
    """Host uint32 words → the int32 tensor that holds their bit pattern
    (shares memory with a contiguous input)."""
    w = np.require(words, dtype=np.uint32, requirements=("C", "W"))
    return torch.from_numpy(w.view(np.int32))
