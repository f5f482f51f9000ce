"""deepseek-v2-lite-16b — MLA (kv_lora 512) + MoE [arXiv:2405.04434].

Layer 0 uses a dense FFN (width 10944, per the HF config); layers 1–26
are MoE with 64 routed experts top-6 plus 2 shared experts of width 1408.
(The assignment note "2 shared+160 routed" mixes in full V2's 160-expert
count; V2-*Lite* has 64 routed — we follow the Lite card, matching the
assigned "MoE 64e top-6".)

MLA decode uses the absorbed-matmul formulation over the *compressed*
cache (c_kv 512 + decoupled rope key 64) — the memory saving that is the
point of MLA."""

from repro_torch.configs.base import ModelConfig, MoESettings, MLASettings

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434 (DeepSeek-V2); hf:deepseek-ai/DeepSeek-V2-Lite",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,            # informational; MLA shares one latent KV
    head_dim=128,
    d_ff=10944,                 # dense FFN of layer 0
    vocab_size=102400,
    prefix_codes=("L-D",),
    cycle_codes=("L-E",),
    mla=MLASettings(kv_lora_rank=512, rope_head_dim=64),
    moe=MoESettings(num_experts=64, top_k=6, d_ff_expert=1408,
                    num_shared=2, d_ff_shared=1408),
    train_microbatches=4,
)
