"""``tests/test_models_smoke.py``'s three training tests on the port, on
the CPU: 30 AdamW steps of a reduced dense, MoE and SSM arch on a fixed
batch, the loss falling below a share of the first."""

import numpy as np
import pytest
import torch

from repro_torch import configs, prng
from repro_torch.models import Model
from repro_torch.optim import get_optimizer
from test_torch_arch_zoo import _one_torch_thread  # noqa: F401  (the fixture)


@pytest.mark.parametrize("arch,drop,seed", [("smollm-360m", 0.7, 0),
                                            ("qwen3-moe-30b-a3b", 0.8, 1),
                                            ("xlstm-1.3b", 0.8, 2)], ids=["dense", "moe", "ssm"])
def test_training_reduces_loss(arch, drop, seed):
    """30 AdamW steps on a fixed (4, 32) batch: the last loss below
    ``drop`` times the first."""
    m = Model(configs.get_config(arch).reduced(), prng.PRNGKey(0), device="cpu")
    opt = get_optimizer("adamw", lr=3e-3)
    with torch.no_grad():
        state = opt.init(m.param_tree())
    step = m.make_train_step(opt)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, m.cfg.vocab_size, (4, 32), dtype=np.int32))
    losses = []
    for i in range(30):
        state, loss = step(state, {"tokens": toks, "labels": toks}, i)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * drop, losses[::10]

