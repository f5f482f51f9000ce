"""qwen1.5-0.5b — dense GQA with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B (config.json)",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    cycle_codes=("A-D",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
