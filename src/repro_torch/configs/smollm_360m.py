"""smollm-360m — llama-architecture small model
[hf:HuggingFaceTB/SmolLM-360M, family card hf:HuggingFaceTB/SmolLM-135M].

15 query heads / 5 KV heads: head counts not divisible by a 16-way
tensor axis — sharding uses the flattened heads×head_dim (=960) axis
(see sharding/rules.py)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    source="hf:HuggingFaceTB/SmolLM-360M (config.json)",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    cycle_codes=("A-D",),
    tie_embeddings=True,
)
