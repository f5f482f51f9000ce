"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517].

xLSTM[7:1]-style interleave: one sLSTM block per 8 (position 2 of the
cycle, following the paper's placement of sLSTM blocks in the first
third of each group), remainder mLSTM. Blocks are self-contained
(d_ff=0): mLSTM carries its own 2× up/down projection, sLSTM its own
output projection.
"""

from repro_torch.configs.base import ModelConfig, SSMSettings

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    source="arXiv:2405.04517 (xLSTM), 1.3B scale table",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    cycle_codes=("m", "m", "s", "m", "m", "m", "m", "m"),
    ssm=SSMSettings(mlstm_expand=2),
    train_microbatches=4,
)
