"""CNV's pooled conv epilogue on a card: `conv_chain(pool=True)`, whose last
layer runs `conv_kernel` with the 2×2 max-pool in its epilogue, bit for bit
against the unpooled chain and `maxpool2d` on the same card, on both of
CNV's pooled chains (conv0-1 on the image, conv3-4 on codes), at batch 1024
and at a ragged batch of 3. The captured forwards' `pooled_epilogue`
counts are held in `tests/test_torch_mobilenet_card.py` (2 a CNV forward,
0 a MobileNet one). Every test takes the `card` fixture and skips without
CUDA. Run on a machine with a card (no JAX needed):

    python -m pytest tests/test_torch_conv_pool_card.py -q --confcutdir=tests
"""

from pathlib import Path

import pytest
import torch

from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
from bnn_pynq_tpu_torch.models.network import mega_stages, prepare_input
from bnn_pynq_tpu_torch.models.params import params_from_numpy
from bnn_pynq_tpu_torch.ops.conv_stack import conv_chain
from bnn_pynq_tpu_torch.ops.thresholds import pooled_epilogue

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("batch", [1024, 3])
@pytest.mark.parametrize("name", ["cnv-w1a1", "cnv-w2a2"])
def test_pooled_kernel_equals_chain_and_maxpool(card, name, batch):
    compiled = load_artifact(str(ROOT / "pretrained" / f"{name}.npz"))
    cfg = compiled.config
    layers, scale, bias = params_from_numpy(
        cfg, compiled.layers, compiled.out_scale, compiled.out_bias, card)
    stages = dict(mega_stages(cfg, layers, scale, bias))
    gen = torch.Generator(device=card)
    gen.manual_seed(2_600_000_000 + batch)
    x = torch.randint(-128, 128, (batch, 32, 32, 3), dtype=torch.int8,
                      device=card, generator=gen)
    act = prepare_input(cfg, x)
    for chain, pool in (("chain0-1", "pool2"), ("chain3-4", "pool5")):
        launches, pooled = conv_chain.launches.value, pooled_epilogue.value
        got = stages[chain](act, pool=True)
        torch.cuda.synchronize()
        assert conv_chain.launches.value == launches + 2
        assert pooled_epilogue.value == pooled + 1
        want = stages[pool](stages[chain](act))
        torch.cuda.synchronize()
        assert got.shape == want.shape, chain
        assert torch.equal(got, want), chain
        assert len(torch.unique(want)) > 1, "a degenerate case"
        act = want
