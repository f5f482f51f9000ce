"""Model configuration schema for the architecture zoo — a copy of
``repro.configs.base`` (plain dataclasses; the port imports nothing of
``repro``, and ``tests/test_torch_models.py`` holds every field of every
arch and of ``reduced()`` equal to the reference's).

A model is a stack of layers described by *layer codes*, declared as
``prefix_codes + cycle_codes × num_cycles``. The reference scans the
cycle over stacked parameters; the port runs the same layers as a loop,
in the same order (``repro_torch.models.transformer``).

Layer code grammar:  ``<mixer>[-<ffn>]``
  mixer: A   GQA attention            S   GQA with sliding window
         L   MLA (DeepSeek-V2)        M   Mamba
         m   mLSTM                    s   sLSTM
         C   GQA self-attn + cross-attn (decoder-only layers of enc-dec)
  ffn:   D   dense SwiGLU             E   MoE             (omitted: none)
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoESettings:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: int | None = None
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    groups: int | None = None   # dispatch groups (None → data-axis size)


@dataclass(frozen=True)
class MLASettings:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64


@dataclass(frozen=True)
class SSMSettings:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None
    mlstm_expand: int = 2
    mlstm_chunk: int = 256    # chunkwise-parallel mLSTM chunk length (0 = sequential)
    slstm_segment: int = 64   # sLSTM remat segment (0 = monolithic scan)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense|moe|ssm|hybrid|vlm|audio
    source: str                         # citation
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                           # dense-FFN width (0 = no dense FFN)
    vocab_size: int

    prefix_codes: tuple = ()
    cycle_codes: tuple = ("A-D",)
    num_cycles: int = 0                 # 0 → derived from num_layers

    head_dim: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_kind: str = "rope"             # rope|mrope
    mrope_sections: tuple = (16, 24, 24)
    attention_window: int | None = None # native SWA (h2o-danube)
    long_context_window: int = 8192     # SWA fallback used only for long_500k

    moe: MoESettings | None = None
    mla: MLASettings | None = None
    ssm: SSMSettings = field(default_factory=SSMSettings)

    encoder_layers: int = 0             # >0 → encoder-decoder
    frontend: str | None = None         # None|vision|audio (stubbed)
    frontend_tokens: int = 1024         # patches per image / stub granularity

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "float32"
    vocab_pad_to: int = 256
    remat: bool = True
    remat_per_layer: bool = False   # nested per-layer remat inside the cycle

    # production training knobs (used by launch/train.py and the dry-run)
    train_optimizer: str = "adamw"      # adamw | adafactor | sgd
    train_microbatches: int = 1         # gradient-accumulation chunks
    fsdp: bool = True                   # also shard weights over 'data'
                                        # (ZeRO-3; off = pure TP × DP)

    # ---------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return (self.vocab_size + m - 1) // m * m

    @property
    def resolved_num_cycles(self) -> int:
        if self.num_cycles:
            return self.num_cycles
        body = self.num_layers - len(self.prefix_codes)
        assert body % len(self.cycle_codes) == 0, (
            f"{self.name}: {body} layers not divisible by cycle "
            f"{len(self.cycle_codes)}")
        return body // len(self.cycle_codes)

    def layer_codes(self) -> list[str]:
        codes = list(self.prefix_codes)
        codes += list(self.cycle_codes) * self.resolved_num_cycles
        assert len(codes) == self.num_layers, (self.name, len(codes))
        return codes

    def parse_code(self, code: str) -> tuple[str, str | None]:
        parts = code.split("-")
        mixer = parts[0]
        ffn = parts[1] if len(parts) > 1 else None
        assert mixer in ("A", "S", "L", "M", "m", "s", "C"), code
        assert ffn in (None, "D", "E"), code
        return mixer, ffn

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: ≤2 cycles, small widths, ≤4 experts."""
        moe = self.moe
        if moe is not None:
            moe = replace(moe, num_experts=min(moe.num_experts, 4),
                          top_k=min(moe.top_k, 2),
                          d_ff_expert=min(moe.d_ff_expert, 128),
                          num_shared=min(moe.num_shared, 1))
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        heads = (heads // kv) * kv  # keep divisibility
        d_model = min(self.d_model, 128)
        cycles = 1 if len(self.cycle_codes) > 2 else 2
        num_layers = len(self.prefix_codes) + cycles * len(self.cycle_codes)
        mla = self.mla
        if mla is not None:
            mla = replace(mla, kv_lora_rank=32, rope_head_dim=16)
        new_head_dim = 32 if self.head_dim else None
        sections = self.mrope_sections
        if self.rope_kind == "mrope":
            half = (new_head_dim or d_model // heads) // 2
            total = sum(sections)
            scaled = [max(1, s * half // total) for s in sections]
            scaled[0] += half - sum(scaled)
            sections = tuple(scaled)
        return replace(
            self,
            num_layers=num_layers,
            num_cycles=cycles,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=new_head_dim,
            mrope_sections=sections,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            moe=moe,
            mla=mla,
            encoder_layers=min(self.encoder_layers, 2),
            attention_window=(min(self.attention_window, 32)
                              if self.attention_window else None),
            long_context_window=64,
            frontend_tokens=min(self.frontend_tokens, 16),
            vocab_pad_to=64,
        )
