"""Offline parameter compiler: BN→threshold folding + packing, and the
artifact format (numpy only)."""

from bnn_pynq_tpu_torch.compiler.artifacts import (  # noqa: F401
    CompiledNetwork, config_from_json, config_to_json, load_artifact,
    save_artifact,
)
from bnn_pynq_tpu_torch.compiler.finnthesizer import (  # noqa: F401
    compile_network,
)
