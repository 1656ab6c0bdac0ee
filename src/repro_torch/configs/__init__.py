"""Config registry: ``get_config(arch)`` returns the full published config,
``get_reduced_config(arch)`` a CPU-test variant of the same family
(<=2 effective layer repeats, d_model<=512, <=4 experts). Also the IMPALA
learner's ``TrainConfig``."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_coder_33b, gemma2_27b,
                                 granite_moe_1b, llama32_vision_90b,
                                 mixtral_8x7b, musicgen_large, qwen3_32b,
                                 qwen3_4b, xlstm_125m, zamba2_2_7b)
from repro_torch.configs.base import ImplContext, ModelConfig, TrainConfig

_REGISTRY = {
    "qwen3-32b": qwen3_32b.CONFIG,
    "xlstm-125m": xlstm_125m.CONFIG,
    "musicgen-large": musicgen_large.CONFIG,
    "llama-3.2-vision-90b": llama32_vision_90b.CONFIG,
    "deepseek-coder-33b": deepseek_coder_33b.CONFIG,
    "zamba2-2.7b": zamba2_2_7b.CONFIG,
    "qwen3-4b": qwen3_4b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b.CONFIG,
    "gemma2-27b": gemma2_27b.CONFIG,
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
}

ARCHS = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


# per-arch overrides that don't follow the generic reduction
_REDUCED_PATTERN = {
    "llama-3.2-vision-90b": ((("attn", "swiglu"), ("xattn", "swiglu")), 1),
    "zamba2-2.7b": ((("mamba", "none"),) * 2, 1),
    "xlstm-125m": ((("mlstm", "none"), ("slstm", "none")), 1),
    "gemma2-27b": ((("local_attn", "geglu"), ("attn", "geglu")), 1),
}


def get_reduced_config(name: str) -> ModelConfig:
    """Small same-family variant for CPU tests."""
    cfg = get_config(name)
    pattern, groups = _REDUCED_PATTERN.get(
        name, (cfg.block_pattern, max(1, 2 // len(cfg.block_pattern))))
    kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4
    overrides = dict(
        name=cfg.name + "-reduced",
        d_model=256,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=64,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=512,
        block_pattern=pattern,
        num_groups=groups,
        sliding_window=32,
        attn_chunk=64,
        ssm_chunk=16,
        xlstm_chunk=16,
        vision_seq=16 if cfg.vision_seq else 0,
        long_context_window=64,
        dtype="float32",
        remat=False,
    )
    if cfg.num_experts:
        # capacity_factor 4.0 => dropless at test scale: capacity-based
        # token dropping depends on the batch's composition, so
        # prefill-vs-decode consistency checks need it off.
        overrides.update(num_experts=4,
                         num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
                         moe_d_ff=128, capacity_factor=4.0)
    if cfg.shared_attn_every:
        overrides["shared_attn_every"] = 2
    if cfg.ssm_state:
        overrides.update(ssm_state=16, ssm_head_dim=32)
    if cfg.attn_scale is not None:
        overrides["attn_scale"] = (256 / 4) ** -0.5
    return dataclasses.replace(cfg, **overrides)


__all__ = ["ARCHS", "ImplContext", "ModelConfig", "TrainConfig",
           "get_config", "get_reduced_config"]
