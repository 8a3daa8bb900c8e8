"""The seven Mosaic probes of `tools/mosaic_probes.py`, on tensors.

Port of the probe functions `probe_lane_concat`, `probe_scratch_lane_store`,
`probe_mid_dim_index`, `probe_pool_reshape_max`, `probe_strided_row_slice`,
`probe_lane_slice_64` and `probe_int32_acc_reshape`. On the TPU each was a
one-primitive Pallas kernel that checked whether the Mosaic compiler lowers
that primitive; here each computes the same function with its own CUDA
kernel (`csrc/mosaic_probes.cu`, entries `bnn_probe_<name>`), and each has
a plain PyTorch version, `<name>_plain`. The two dot probes run on the int8
tensor cores, through one kernel whose shared memory `dot_smem_bytes`
sizes.

With no inputs a probe makes JAX's: `ones` of the probe's shape and dtype
(M = 1024, C = 64, O = 64, K = 9), and for the pool `arange(m·C)` cast to
int8, which wraps, on `device`: the card by default, as JAX's probes run on
its default backend; with no CUDA that raises (pass `device="cpu"` for the
plain versions). A tensor passed in decides the device: a CPU tensor runs
the plain version, a CUDA tensor launches the kernel, whose launches each
wrapper counts in `.launches`.
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

# the dot kernel's shared memory (csrc/mma_tile.cuh, csrc/common.cuh,
# csrc/mosaic_probes.cu::launch_shifted_dot)
MMA_K, ITEM_ROWS, ITEM_COLS, PITCH_PAD = 32, 32, 64, 16
RAW_PITCH = ITEM_COLS + 16                  # a row of the raw weight tile
TILE_BYTES = ITEM_ROWS * (ITEM_COLS + 8) * 4  # the int32 output tile
MAX_SMEM = 227 * 1024                       # the H100's opt-in limit


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _padded_pitch(nbytes: int) -> int:
    """The smallest pitch >= nbytes that is ≡ 16 (mod 32)."""
    return _round_up(nbytes, MMA_K) + PITCH_PAD


def dot_smem_bytes(c: int, taps: int, concat: bool) -> int:
    """Shared bytes of a block of the dot kernel: the A tile (lane_concat:
    32 + taps - 1 x rows padded to Cp = round_up(C, 32); scratch_lane_store:
    32 patch rows of Kp = round_up(taps·C, 32)), 64 weight columns of the
    staged K (taps·Cp, or Kp), the raw tile they are transposed from
    (taps·C rows of 80 bytes), the int32 output tile the warps add their
    partial sums into, and the A tile's mbarrier."""
    if concat:
        cp = _round_up(c, MMA_K)
        a_bytes = (ITEM_ROWS + taps - 1) * _padded_pitch(cp)
        kp = taps * cp
    else:
        kp = _round_up(taps * c, MMA_K)
        a_bytes = ITEM_ROWS * _padded_pitch(kp)
    return (a_bytes + ITEM_COLS * _padded_pitch(kp) + taps * c * RAW_PITCH
            + TILE_BYTES + 16)


def _check_smem(c: int, taps: int, concat: bool) -> None:
    need = dot_smem_bytes(c, taps, concat)
    if need > MAX_SMEM:
        raise ValueError(f"C = {c}, taps = {taps} need {need} bytes of "
                         f"shared memory a block, above the card's "
                         f"{MAX_SMEM}")


def _device(device) -> torch.device:
    """Where a probe with no input tensor makes JAX's inputs."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available; pass "
                           "device='cpu' to run the plain version")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


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
    if x is None:
        x = torch.ones((M + 128, C), dtype=torch.int8,
                       device=_device(device))
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
                      device="cuda") -> torch.Tensor:
    """out[r, o] = Σ_i Σ_c x[r+i, c] · w[i·C + c, o] for r < m: int8 x
    [>= m + taps - 1, C], int8 w [taps·C, O] → int32 [m, O]."""
    x, w, taps = _dot_inputs(x, w, m, device)
    if x.device.type == "cpu":
        return probe_lane_concat_plain(x, w, m=m)
    _check_smem(x.shape[1], taps, concat=True)
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
                             m: int = M, device="cuda") -> torch.Tensor:
    """`probe_lane_concat`'s function through a shared-memory patch tile;
    on the card, its block's shared memory (`dot_smem_bytes`) may not
    exceed 227 KB."""
    x, w, taps = _dot_inputs(x, w, m, device)
    if x.device.type == "cpu":
        return probe_scratch_lane_store_plain(x, w, m=m)
    _check_smem(x.shape[1], taps, concat=False)
    out = torch.empty((m, w.shape[1]), dtype=torch.int32, device=x.device)
    _launch("bnn_probe_scratch_lane_store", out, x, w,
            args=(x.data_ptr(), m, x.shape[1], w.data_ptr(), taps,
                  w.shape[1]))
    probe_scratch_lane_store.launches.add()
    return out


# -- the copies and reductions ----------------------------------------------

def _ones(x, shape, dtype, device):
    if x is None:
        return torch.ones(shape, dtype=dtype, device=_device(device))
    return x


def probe_mid_dim_index_plain(x) -> torch.Tensor:
    """Plain version: [R, C] → [R/2, 2, C], index 0 of the middle dim."""
    r, c = x.shape
    return _contiguous_copy(x.reshape(r // 2, 2, c)[:, 0, :])


def probe_mid_dim_index(x: Optional[torch.Tensor] = None, *,
                        device="cuda") -> torch.Tensor:
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
               c: int = C, device="cuda") -> torch.Tensor:
    """JAX's pool probe input: arange(bb·h·w·C) as int32, cast to int8
    (wrapping), as [bb·h·w, C]."""
    n = bb * h * w
    return torch.arange(n * c, dtype=torch.int32,
                        device=_device(device)).to(torch.int8) \
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
                           w: int = POOL_W, device="cuda") -> torch.Tensor:
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
                            stride: int = 2, device="cuda") -> torch.Tensor:
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
                        device="cuda") -> torch.Tensor:
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
                            device="cuda") -> torch.Tensor:
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
