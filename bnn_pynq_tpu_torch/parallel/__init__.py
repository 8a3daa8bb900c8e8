"""Multi-rank inference on torch.distributed: meshes, tensor-parallel
engines (packed kernels on output-channel shards; rings that overlap the
collectives with the compute), and the scaling harness."""

from bnn_pynq_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
