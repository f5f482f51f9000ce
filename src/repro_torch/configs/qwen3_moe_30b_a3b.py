"""qwen3-moe-30b-a3b — 128 experts, top-8, all-MoE FFN
[hf:Qwen/Qwen3-30B-A3B]."""

from repro_torch.configs.base import ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    source="hf:Qwen/Qwen3-30B-A3B (config.json)",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,                     # every FFN is MoE
    vocab_size=151936,
    cycle_codes=("A-E",),
    rope_theta=1_000_000.0,
    moe=MoESettings(num_experts=128, top_k=8, d_ff_expert=768),
    train_microbatches=8,
)
