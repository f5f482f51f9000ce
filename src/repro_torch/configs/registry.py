"""Architecture registry: ``--arch <id>`` resolution (a copy of
``repro.configs.registry``, resolving to the port's copies of the arch
files)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
}

ARCH_IDS = tuple(_MODULES)

# Decode shapes this arch cannot run, with the DESIGN.md reason.
LONG_500K_SKIPS = {
    "seamless-m4t-large-v2":
        "enc-dec: full attention over a 500k-frame encoder is quadratic; "
        "no sub-quadratic variant in scope (DESIGN.md §5)",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def supports_shape(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(supported, reason-if-not). long_500k policy per DESIGN.md:
    SSM/hybrid run natively; native-SWA dense runs natively; other
    dense/moe/vlm archs run with the sliding-window variant (the config
    is overridden with ``attention_window=long_context_window``);
    enc-dec audio is skipped."""
    if shape_name != "long_500k":
        return True, ""
    if cfg.name in LONG_500K_SKIPS:
        return False, LONG_500K_SKIPS[cfg.name]
    return True, ""


def config_for_shape(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """Shape-specific config adjustments (the SWA fallback for long_500k)."""
    if shape_name == "long_500k" and cfg.attention_window is None:
        has_attn = any(cfg.parse_code(c)[0] in ("A", "S", "L", "C")
                       for c in cfg.layer_codes())
        pure_recurrent = not has_attn
        if not pure_recurrent and cfg.arch_type in ("dense", "moe", "vlm"):
            return cfg.with_overrides(attention_window=cfg.long_context_window)
    return cfg
