"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 with MoE every other
layer [arXiv:2403.19887 / arXiv:2408.12570].

72 layers = 9 cycles of 8 (attention at cycle position 3, MoE on odd
positions). Optimizer is adafactor: AdamW fp32 state for 398B params is
~4.8 TB and does not fit a single 256×16 GB pod (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig, MoESettings, SSMSettings

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    source="arXiv:2403.19887 (Jamba); 1.5-Large sizes from arXiv:2408.12570",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    cycle_codes=("M-D", "M-E", "M-D", "A-E", "M-D", "M-E", "M-D", "M-E"),
    moe=MoESettings(num_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMSettings(d_state=16, d_conv=4, expand=2),
    train_optimizer="adafactor",
    train_microbatches=16,
)
