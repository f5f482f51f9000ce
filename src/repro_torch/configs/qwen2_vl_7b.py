"""qwen2-vl-7b — VLM with M-RoPE + dynamic resolution [arXiv:2409.12191].

The vision tower (ViT + merger) is stubbed per the assignment carve-out:
``input_specs`` supplies pre-projected patch embeddings
(B, frontend_tokens, d_model); this config is the language decoder that
consumes them, with multimodal rotary position embedding (sections
16/24/24 over the 64 half-dim frequency bands).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    source="arXiv:2409.12191 (Qwen2-VL); hf:Qwen/Qwen2-VL-7B-Instruct",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    cycle_codes=("A-D",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    frontend="vision",
    frontend_tokens=1024,
    train_microbatches=8,
)
