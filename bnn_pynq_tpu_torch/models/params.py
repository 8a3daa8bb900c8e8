"""Carry parameters across from the JAX package's format to tensors.

`params_from_numpy` takes the per-layer numpy dicts of a `CompiledNetwork`
(`w_packed` uint32 words, `w_int8` levels, `thr` int32) and returns the
port's parameters on a device: decoded int8 levels for the `mega` route
and the reference, and the packed words themselves for the packed routes.
Words are decoded with ops/packing.py (bit j of word w is element 32w+j,
1-bit value 2b−1; 2-bit code j sits at bits [2j, 2j+2), level 2c−3); the
K padding of the last word is dropped, as
`bnn_pynq_tpu/models/network.py::decode_params` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bnn_pynq_tpu_torch.models.config import NetworkConfig
from bnn_pynq_tpu_torch.models.network import make_plan
from bnn_pynq_tpu_torch.ops.int_dot import k_contiguous
from bnn_pynq_tpu_torch.ops.matmul import unpack_levels as unpack_words
from bnn_pynq_tpu_torch.ops.packing import words_to_tensor
from bnn_pynq_tpu_torch.ops.thresholds import sort_thresholds

# The tensor-core kernels (csrc/mma_tile.cuh) consume K in steps of 32
# bytes, the depth of one int8 mma, so their weight copy pads K with zero
# levels to a multiple of 32. A zero level adds nothing to the dot, whatever
# the activation it meets.
K_ALIGN_MMA = 32
# The whole-MLP kernel (csrc/dense_chain.cu) fetches its weights in tiles of
# this many bytes of K a row, 16-byte chunks at a time.
K_TILE = 128
K_CHUNK = 16


@dataclass(frozen=True)
class WeightMatrix:
    """int8 weight levels of one layer in the layouts in use.

    kn: [K, N], K in (ki, kj, c) order — the JAX layout, used by the plain
        versions and the reference.
    nk32: [N, Kp], K contiguous and zero-padded to Kp = K rounded up to
        K_ALIGN_MMA — what the tensor-core kernels read (`conv_chain`,
        `dense_block`, `conv2d_direct`, `conv_chain_direct`).
    wsum: int32 [N], the column sums of the levels. Those kernels run the
        dot on activation codes c, not levels 2c − off, and correct it
        with Σ level·w = 2·Σ c·w − off·wsum.
    tiles: [ceil(K / K_TILE), N, K_TILE], `nk32` cut into K slices of K_TILE
        bytes, slice-major (zero past K), so that the rows n0..n1 of one
        slice are one contiguous run that `fused_mlp`'s kernel fetches with
        one bulk copy (and `conv2d_direct`'s, for a conv whose kernel covers
        its input). Within a row's slice the K_CHUNK-byte chunk c lies
        at position c ^ (n & 7): read at a pitch of K_TILE bytes, the same
        chunk of 8 neighbouring rows then falls in 8 different bank groups
        of shared memory.
    """
    kn: torch.Tensor
    nk32: torch.Tensor
    wsum: torch.Tensor
    tiles: torch.Tensor


def _padded_nk(kn: torch.Tensor) -> torch.Tensor:
    k, n = kn.shape
    nk = torch.zeros((n, -(-k // K_ALIGN_MMA) * K_ALIGN_MMA),
                     dtype=torch.int8, device=kn.device)
    nk[:, :k] = kn.t()
    return nk


def _k_tiles(nk32: torch.Tensor) -> torch.Tensor:
    n, k32 = nk32.shape
    slices = -(-k32 // K_TILE)
    chunks = K_TILE // K_CHUNK
    padded = torch.zeros((n, slices * K_TILE), dtype=torch.int8,
                         device=nk32.device)
    padded[:, :k32] = nk32
    # position p of row n holds chunk p ^ (n & 7): the XOR is its own inverse
    src = torch.arange(chunks, device=nk32.device)[None, :] ^ \
        (torch.arange(n, device=nk32.device)[:, None] & (chunks - 1))
    t = padded.reshape(n, slices, chunks, K_CHUNK)
    t = torch.gather(t, 2, src[:, None, :, None].expand_as(t))
    return t.permute(1, 0, 2, 3).reshape(slices, n, K_TILE).contiguous()


def weight_matrix(kn: torch.Tensor) -> WeightMatrix:
    """Build every layout from int8 levels [K, N] (on kn's device)."""
    if kn.dtype != torch.int8 or kn.ndim != 2:
        raise TypeError(f"weights must be int8 [K, N], got {kn.dtype} "
                        f"{tuple(kn.shape)}")
    nk32 = _padded_nk(kn)
    return WeightMatrix(kn=kn.contiguous(), nk32=nk32,
                        wsum=kn.sum(dim=0, dtype=torch.int32),
                        tiles=_k_tiles(nk32))


def unpack_levels(w_packed: np.ndarray, k: int, bits: int) -> np.ndarray:
    """uint32 words [Kw, N] packed along K → int8 levels [k, N]."""
    if bits not in (1, 2):
        raise ValueError(f"unsupported packing width bits={bits}")
    return unpack_words(words_to_tensor(w_packed), k, bits, axis=0).numpy()


Params = Tuple[List[Dict[str, object]], torch.Tensor, torch.Tensor]


def params_from_numpy(config: NetworkConfig,
                      layers: Sequence[Dict[str, np.ndarray]],
                      out_scale, out_bias, device) -> Params:
    """Decode a CompiledNetwork's numpy layers onto `device`.

    Returns `(layers, out_scale, out_bias)`: per config layer `{}` for a
    pool, `{"thr": int32 [nthr, C]}` for an average pool, else
    `{"w": WeightMatrix, "thr": int32 [nthr, N]}` (no "thr" where the
    artifact has none, i.e. on the last layer; a 15-row table with each
    channel sorted ascending, `ops/thresholds.py::sort_thresholds`, which
    the kernels' search needs; 1-3 rows as the artifact has them), plus
    `"w_packed"`, the artifact's uint32 words [Kw, N] as an int32 tensor,
    on every packed layer (all but an 8-bit first conv), and `"w_int8"`,
    the levels [K, N] stored K-contiguous (`ops/int_dot.py::k_contiguous`):
    the weight `int_matmul` (cuBLASLt's int8 GEMM) takes without a copy,
    where a route leaves a product to the library as JAX leaves it to
    XLA's int8 dot, and what `decode_params` reshapes; a bottleneck
    block's `bottleneck_params`; out_scale and out_bias float32
    [num_classes]. The engine publishes this tuple as one unit.
    """
    device = torch.device(device)
    plan = make_plan(config)
    if len(layers) != len(plan):
        raise ValueError(f"{len(layers)} parameter layers for a "
                         f"{len(plan)}-layer network")
    out = []
    # np.array copies: the inputs may be read-only (jax or np.load views)
    for lp, p in zip(plan, layers):
        if lp.kind in ("pool", "maxpool"):
            out.append({})
            continue
        if lp.kind == "avgpool":
            out.append({"thr": torch.from_numpy(
                sort_thresholds(p["thr"])).to(device)})
            continue
        if lp.kind == "bottleneck":
            out.append(bottleneck_params(lp, p, device))
            continue
        if "w_int8" in p:
            w_lev = np.array(p["w_int8"], dtype=np.int8)
        else:
            w_lev = unpack_levels(p["w_packed"], lp.k, config.bits)
        if w_lev.shape != (lp.k, lp.n):
            raise ValueError(f"layer weights {w_lev.shape} != "
                             f"{(lp.k, lp.n)}")
        q = {"w": weight_matrix(torch.from_numpy(w_lev).to(device))}
        q["w_int8"] = k_contiguous(q["w"].kn)
        if "w_packed" in p:
            q["w_packed"] = words_to_tensor(
                np.array(p["w_packed"], dtype=np.uint32)).to(device)
        if "thr" in p:
            q["thr"] = torch.from_numpy(sort_thresholds(p["thr"])).to(device)
        out.append(q)
    scale = torch.from_numpy(np.array(out_scale, dtype=np.float32)).to(device)
    bias = torch.from_numpy(np.array(out_bias, dtype=np.float32)).to(device)
    return out, scale, bias


# the largest shortcut multiplier r: W_p·diag(r) must stay int8
MAX_SHORTCUT_MUL = 127


def bottleneck_params(lp, p: Dict[str, np.ndarray], device) -> Dict:
    """A bottleneck block's artifact arrays (`compiler/artifacts.py`) on
    `device`: `wa`, `wb` (WeightMatrix of W_a [C, mid] and W_b [9·mid,
    mid]) with `thr_a`, `thr_b`; `r` (int32 [out]); `wc`, the block's last
    product: W_c [mid, out] where the shortcut is the identity, and where
    it is a projection [W_c ; W_p·diag(r)] [mid + C, out], whose product
    with the codes [b | x at the stride] is c + r ⊙ p in one accumulator;
    `thr` (int32 [nthr, out]). Raises ValueError on a shape that is not
    the plan's or an r outside [1, MAX_SHORTCUT_MUL]."""
    c, mid, n = lp.k, lp.mid, lp.n

    def levels(name, k, cols):
        w = unpack_levels(p[name], k, 1)
        if w.shape != (k, cols):
            raise ValueError(f"{name}: weights {w.shape} != {(k, cols)}")
        return w

    r = np.array(p["r"], dtype=np.int32)
    if r.shape != (n,) or r.min() < 1 or r.max() > MAX_SHORTCUT_MUL:
        raise ValueError(f"shortcut multipliers r: shape {r.shape}, range "
                         f"[{r.min()}, {r.max()}]; want [{n}] in "
                         f"[1, {MAX_SHORTCUT_MUL}]")
    wc = levels("wc_packed", mid, n)
    if lp.projection:
        wp = levels("wp_packed", c, n).astype(np.int32) * r[None, :]
        wc = np.concatenate([wc, wp.astype(np.int8)])
    elif c != n or lp.stride != 1:
        raise ValueError(f"an identity shortcut maps {c} channels to {n} "
                         f"at stride {lp.stride}")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"wa": weight_matrix(dev(levels("wa_packed", c, mid))),
            "thr_a": dev(sort_thresholds(p["thr_a"])),
            "wb": weight_matrix(dev(levels("wb_packed", 9 * mid, mid))),
            "thr_b": dev(sort_thresholds(p["thr_b"])),
            "wc": weight_matrix(dev(wc)), "r": dev(r),
            "thr": dev(sort_thresholds(p["thr"]))}
