"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].

Native SWA (window 4096): the KV cache never exceeds the window, which
also makes this the one *dense* arch that runs long_500k natively."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    arch_type="dense",
    source="arXiv:2401.16818 (H2O-Danube-1.8B)",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    cycle_codes=("A-D",),
    attention_window=4096,
)
