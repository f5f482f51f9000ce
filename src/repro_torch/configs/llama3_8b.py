"""llama3-8b — dense GQA, 128k vocab [arXiv:2407.21783]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    source="arXiv:2407.21783 (The Llama 3 Herd of Models)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cycle_codes=("A-D",),
    rope_theta=500_000.0,
    train_microbatches=8,
)
