"""The seven Mosaic probes of `tools/mosaic_probes.py`, on tensors.

Port of the probe functions `probe_lane_concat`, `probe_scratch_lane_store`,
`probe_mid_dim_index`, `probe_pool_reshape_max`, `probe_strided_row_slice`,
`probe_lane_slice_64` and `probe_int32_acc_reshape`. On the TPU each was a
one-primitive Pallas kernel that checked whether the Mosaic compiler lowers
that primitive; here each computes the same function with its own CUDA
kernel (`csrc/mosaic_probes.cu`, entries `bnn_probe_<name>`), and each has
a plain PyTorch version, `<name>_plain`.

With no inputs a probe makes JAX's: `ones` of the probe's shape and dtype
(M = 1024, C = 64, O = 64, K = 9), and for the pool `arange(m·C)` cast to
int8, which wraps. A CPU tensor runs the plain version; a CUDA tensor
launches the kernel, whose launches each wrapper counts in `.launches`.
"""

from __future__ import annotations

from typing import Optional

import torch

from bnn_pynq_tpu_torch.ops import _build
from bnn_pynq_tpu_torch.ops.ref import int_matmul_ref

M, C, O = 1024, 64, 64
K = 9
POOL_BB, POOL_H, POOL_W = 4, 16, 16
LANE_LO, LANE_HI = 64, 128


def _contiguous_copy(t: torch.Tensor) -> torch.Tensor:
    """A view's elements as a new contiguous tensor: the plain row and lane
    slices copy, as the kernels do, instead of returning views."""
    return t.clone(memory_format=torch.contiguous_format)


def _check(x: torch.Tensor, dtype: torch.dtype, name: str = "x") -> None:
    if x.dtype != dtype or x.ndim != 2:
        raise ValueError(f"{name} must be {dtype} 2-D, got {x.dtype} "
                         f"{tuple(x.shape)}")


def _launch(entry: str, out: torch.Tensor, *inputs: torch.Tensor,
            args=()) -> torch.Tensor:
    """Call a probe's launcher on the inputs' current stream; raise on a
    CUDA error."""
    for t in inputs:
        if t.device.type != "cuda":
            raise ValueError(f"no kernel for device {t.device}; tensors "
                             "must be on the CPU (plain version) or on CUDA")
        if t.device != out.device or not t.is_contiguous():
            raise ValueError("the probe kernels take contiguous tensors on "
                             "one device")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _build.library().call(entry, *args, out.data_ptr(), stream)
    return out


# -- lane_concat and scratch_lane_store: the shifted-row dot ----------------

def _dot_inputs(x, w, m: int, device):
    device = x.device if x is not None else torch.device(device)
    if x is None:
        x = torch.ones((M + 128, C), dtype=torch.int8, device=device)
    if w is None:
        w = torch.ones((K * C, O), dtype=torch.int8, device=x.device)
    _check(x, torch.int8)
    _check(w, torch.int8, "w")
    c = x.shape[1]
    taps = w.shape[0] // c
    if taps * c != w.shape[0] or x.shape[0] < m + taps - 1:
        raise ValueError(f"w rows {w.shape[0]} must be taps·{c}, and x "
                         f"needs >= m + taps - 1 rows, got {x.shape[0]}")
    return x, w, taps


def probe_lane_concat_plain(x, w, *, m: int = M) -> torch.Tensor:
    """Plain version: the `taps` shifted row slices concatenated along the
    last axis, then one exact int32 dot."""
    c = x.shape[1]
    taps = w.shape[0] // c
    return int_matmul_ref(torch.cat([x[i:i + m] for i in range(taps)],
                                    dim=1), w)


def probe_lane_concat(x: Optional[torch.Tensor] = None,
                      w: Optional[torch.Tensor] = None, *, m: int = M,
                      device="cpu") -> torch.Tensor:
    """out[r, o] = Σ_i Σ_c x[r+i, c] · w[i·C + c, o] for r < m: int8 x
    [>= m + taps - 1, C], int8 w [taps·C, O] → int32 [m, O]."""
    x, w, taps = _dot_inputs(x, w, m, device)
    if x.device.type == "cpu":
        return probe_lane_concat_plain(x, w, m=m)
    out = torch.empty((m, w.shape[1]), dtype=torch.int32, device=x.device)
    _launch("bnn_probe_lane_concat", out, x, w,
            args=(x.data_ptr(), m, x.shape[1], w.data_ptr(), taps,
                  w.shape[1]))
    probe_lane_concat.launches.add()
    return out


def probe_scratch_lane_store_plain(x, w, *, m: int = M) -> torch.Tensor:
    """Plain version: the slices are stored into an [m, taps·C] scratch at
    C-column offsets, then the dot runs from the scratch."""
    c = x.shape[1]
    taps = w.shape[0] // c
    scratch = torch.empty((m, taps * c), dtype=torch.int8, device=x.device)
    for i in range(taps):
        scratch[:, i * c:(i + 1) * c] = x[i:i + m]
    return int_matmul_ref(scratch, w)


def probe_scratch_lane_store(x: Optional[torch.Tensor] = None,
                             w: Optional[torch.Tensor] = None, *,
                             m: int = M, device="cpu") -> torch.Tensor:
    """`probe_lane_concat`'s function through a shared-memory patch tile;
    taps·C may not exceed 48 KB on the card."""
    x, w, taps = _dot_inputs(x, w, m, device)
    if x.device.type == "cpu":
        return probe_scratch_lane_store_plain(x, w, m=m)
    if taps * x.shape[1] > 48 * 1024:
        raise ValueError(f"a patch row of {taps * x.shape[1]} bytes does "
                         "not fit the kernel's 48 KB tile")
    out = torch.empty((m, w.shape[1]), dtype=torch.int32, device=x.device)
    _launch("bnn_probe_scratch_lane_store", out, x, w,
            args=(x.data_ptr(), m, x.shape[1], w.data_ptr(), taps,
                  w.shape[1]))
    probe_scratch_lane_store.launches.add()
    return out


# -- the copies and reductions ----------------------------------------------

def _ones(x, shape, dtype, device):
    if x is None:
        return torch.ones(shape, dtype=dtype, device=torch.device(device))
    return x


def probe_mid_dim_index_plain(x) -> torch.Tensor:
    """Plain version: [R, C] → [R/2, 2, C], index 0 of the middle dim."""
    r, c = x.shape
    return _contiguous_copy(x.reshape(r // 2, 2, c)[:, 0, :])


def probe_mid_dim_index(x: Optional[torch.Tensor] = None, *,
                        device="cpu") -> torch.Tensor:
    """The even rows of int8 [R, C] (R even) → [R/2, C]."""
    x = _ones(x, (M, C), torch.int8, device)
    _check(x, torch.int8)
    if x.shape[0] % 2:
        raise ValueError(f"rows {x.shape[0]} must be even")
    if x.device.type == "cpu":
        return probe_mid_dim_index_plain(x)
    rows, c = x.shape[0] // 2, x.shape[1]
    out = torch.empty((rows, c), dtype=torch.int8, device=x.device)
    _launch("bnn_probe_mid_dim_index", out, x, args=(x.data_ptr(), rows, c))
    probe_mid_dim_index.launches.add()
    return out


def pool_input(bb: int = POOL_BB, h: int = POOL_H, w: int = POOL_W,
               c: int = C, device="cpu") -> torch.Tensor:
    """JAX's pool probe input: arange(bb·h·w·C) as int32, cast to int8
    (wrapping), as [bb·h·w, C]."""
    n = bb * h * w
    return torch.arange(n * c, dtype=torch.int32,
                        device=torch.device(device)).to(torch.int8) \
        .reshape(n, c)


def probe_pool_reshape_max_plain(x, *, bb: int = POOL_BB, h: int = POOL_H,
                                 w: int = POOL_W) -> torch.Tensor:
    """Plain version, JAX's steps: the max of row pairs, then of column
    pairs."""
    c = x.shape[1]
    v = x.reshape(bb, h // 2, 2, w, c)
    rmax = torch.maximum(v[:, :, 0], v[:, :, 1])
    v2 = rmax.reshape(bb, h // 2, w // 2, 2, c)
    out = torch.maximum(v2[:, :, :, 0], v2[:, :, :, 1])
    return out.reshape(bb * (h // 2) * (w // 2), c)


def probe_pool_reshape_max(x: Optional[torch.Tensor] = None, *,
                           bb: int = POOL_BB, h: int = POOL_H,
                           w: int = POOL_W, device="cpu") -> torch.Tensor:
    """2×2 max pool of int8 rows [bb·h·w, C] (pixels of [bb, h, w], h and
    w even) → [bb·(h/2)·(w/2), C]."""
    if x is None:
        x = pool_input(bb, h, w, C, device)
    _check(x, torch.int8)
    if x.shape[0] != bb * h * w or h % 2 or w % 2:
        raise ValueError(f"x rows {x.shape[0]} must be bb·h·w = "
                         f"{bb * h * w}, with h and w even")
    if x.device.type == "cpu":
        return probe_pool_reshape_max_plain(x, bb=bb, h=h, w=w)
    c = x.shape[1]
    out = torch.empty((bb * (h // 2) * (w // 2), c), dtype=torch.int8,
                      device=x.device)
    _launch("bnn_probe_pool_reshape_max", out, x,
            args=(x.data_ptr(), bb, h, w, c))
    probe_pool_reshape_max.launches.add()
    return out


def probe_strided_row_slice_plain(x, *, stride: int = 2) -> torch.Tensor:
    """Plain version: rows 0, stride, 2·stride, ... (`lax.slice`)."""
    return _contiguous_copy(x[::stride])


def probe_strided_row_slice(x: Optional[torch.Tensor] = None, *,
                            stride: int = 2, device="cpu") -> torch.Tensor:
    """Rows 0, stride, ... of int8 [R, C] → [ceil(R/stride), C]."""
    x = _ones(x, (M, C), torch.int8, device)
    _check(x, torch.int8)
    if stride < 1:
        raise ValueError(f"stride {stride} must be >= 1")
    if x.device.type == "cpu":
        return probe_strided_row_slice_plain(x, stride=stride)
    rows, c = x.shape
    out = torch.empty((-(-rows // stride), c), dtype=torch.int8,
                      device=x.device)
    _launch("bnn_probe_strided_row_slice", out, x,
            args=(x.data_ptr(), rows, c, stride))
    probe_strided_row_slice.launches.add()
    return out


def probe_lane_slice_64_plain(x) -> torch.Tensor:
    """Plain version: x[:, 64:128] as a new tensor."""
    return _contiguous_copy(x[:, LANE_LO:LANE_HI])


def probe_lane_slice_64(x: Optional[torch.Tensor] = None, *,
                        device="cpu") -> torch.Tensor:
    """The lane window x[:, 64:128] of int8 [M, N >= 128] → [M, 64]."""
    x = _ones(x, (M, 256), torch.int8, device)
    _check(x, torch.int8)
    if x.shape[1] < LANE_HI:
        raise ValueError(f"x needs >= {LANE_HI} columns, got {x.shape[1]}")
    if x.device.type == "cpu":
        return probe_lane_slice_64_plain(x)
    m, n = x.shape
    out = torch.empty((m, LANE_HI - LANE_LO), dtype=torch.int8,
                      device=x.device)
    _launch("bnn_probe_lane_slice_64", out, x,
            args=(x.data_ptr(), m, n, LANE_LO, LANE_HI - LANE_LO))
    probe_lane_slice_64.launches.add()
    return out


def probe_int32_acc_reshape_plain(x) -> torch.Tensor:
    """Plain version: [R, C] → [R/4, 4, C], max over the middle dim."""
    r, c = x.shape
    return x.reshape(r // 4, 4, c).amax(dim=1)


def probe_int32_acc_reshape(x: Optional[torch.Tensor] = None, *,
                            device="cpu") -> torch.Tensor:
    """Max over each group of 4 rows of int32 [R, C] (R % 4 == 0) →
    [R/4, C]."""
    x = _ones(x, (M, C), torch.int32, device)
    _check(x, torch.int32)
    if x.shape[0] % 4:
        raise ValueError(f"rows {x.shape[0]} must be a multiple of 4")
    if x.device.type == "cpu":
        return probe_int32_acc_reshape_plain(x)
    rows, c = x.shape[0] // 4, x.shape[1]
    out = torch.empty((rows, c), dtype=torch.int32, device=x.device)
    _launch("bnn_probe_int32_acc_reshape", out, x,
            args=(x.data_ptr(), rows, 4, c))
    probe_int32_acc_reshape.launches.add()
    return out


PROBES = (probe_lane_concat, probe_scratch_lane_store, probe_mid_dim_index,
          probe_pool_reshape_max, probe_strided_row_slice,
          probe_lane_slice_64, probe_int32_acc_reshape)
for _probe in PROBES:
    _probe.launches = _build.LaunchCounter()
