"""Multi-rank inference and training on torch.distributed: meshes,
tensor-parallel engines (packed kernels on output-channel shards; rings
that overlap the collectives with the compute), the scaling harness, and
dp×tp sharded training."""

from bnn_pynq_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from bnn_pynq_tpu_torch.parallel.train_sharded import (  # noqa: F401
    gather_variables, init_sharded, make_sharded_epoch_fn,
    make_sharded_train_step)
