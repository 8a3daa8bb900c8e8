"""Device mesh construction: a ('data', 'model') mesh of ranks.

Port of `bnn_pynq_tpu/parallel/mesh.py::make_mesh`. The batch goes over
'data', packed-weight output channels over 'model'. JAX builds the mesh
from the devices of one process; here every rank of a `torch.distributed`
world calls `make_mesh` with the same arguments (it creates process
groups, which every rank must join) and gets its own view of the mesh:
its coordinates, its device and the groups of its row and column.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a ('data', 'model') mesh.

    shape: {"data": d, "model": m}, as JAX's `Mesh.shape`.
    ranks: global ranks [d, m]; row i is data index i.
    coords: (data index, model index) of this rank, or None for a rank of
        the world outside the mesh.
    device: where this rank computes: `cuda:{local rank % cards}`, or the
        CPU where the caller asked for it.
    device_mesh: torch's DeviceMesh over `ranks`, dims ("data", "model");
        its device type is that of the collectives' tensors (cuda under
        NCCL, cpu under gloo).
    group: every rank of the mesh (the serving header's broadcast).
    """
    shape: dict
    ranks: np.ndarray
    coords: Optional[Tuple[int, int]]
    device: torch.device
    device_mesh: DeviceMesh
    group: object

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def data_group(self):
        """The ranks that share this rank's model index (its column)."""
        return self.device_mesh.get_group("data")

    @property
    def model_group(self):
        """The ranks that share this rank's data index (its row)."""
        return self.device_mesh.get_group("model")

    @property
    def leader(self) -> int:
        """Global rank of mesh position (0, 0): the serving leader."""
        return int(self.ranks[0, 0])


def make_mesh(data: Optional[int] = None, model: Optional[int] = None,
              devices: Optional[Sequence[int]] = None, *,
              device: str = "cuda") -> Mesh:
    """Build a ('data', 'model') mesh over the world's ranks.

    devices: the global ranks to use, in mesh order (default: all).
    Defaults: all ranks on the data axis (pure DP) unless `model` is
    given; data·model ranks are taken from the front, and more than there
    are raises ValueError. device="cuda" (default) puts this rank on card
    local_rank % device_count and raises without CUDA; "cpu" on the CPU.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the "
                           "ranks with parallel.launch.run_world or call "
                           "torch.distributed.init_process_group first")
    if devices is None:
        devices = range(dist.get_world_size())
    devices = [int(r) for r in devices]
    n = len(devices)
    if model is None and data is None:
        data, model = n, 1
    elif model is None:
        model = n // data
    elif data is None:
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {n}")
    ranks = np.asarray(devices[: data * model]).reshape(data, model)

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")

    comm_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    names = ("data", "model")
    if ranks.ravel().tolist() == list(range(data * model)):
        dm = init_device_mesh(comm_type, (data, model), mesh_dim_names=names)
    else:
        dm = DeviceMesh(comm_type, torch.as_tensor(ranks),
                        mesh_dim_names=names)
    if data * model == dist.get_world_size():
        group = dist.group.WORLD
    else:
        group = dist.new_group(ranks.ravel().tolist())
    me = np.argwhere(ranks == dist.get_rank())
    coords = (int(me[0, 0]), int(me[0, 1])) if len(me) else None
    return Mesh(shape={"data": data, "model": model}, ranks=ranks,
                coords=coords, device=device, device_mesh=dm, group=group)
