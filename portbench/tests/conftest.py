"""The benchmark's tests. Those marked `card` need a CUDA device: the
`card` fixture decides at run time and skips without one. On a machine
without JAX run them with `--confcutdir=portbench`, which keeps the
repository's root conftest (it imports JAX) out:

    python -m pytest portbench/tests -q --confcutdir=portbench
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
