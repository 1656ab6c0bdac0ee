"""Qwen3-4B [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family card]

36L, d_model=2560, 32 heads (GQA kv=8, head_dim=128), d_ff=9728,
vocab=151936. Tied embeddings, RoPE theta 1e6.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B (family); Qwen3 technical report",
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    block_pattern=(("attn", "swiglu"),),
    num_groups=36,
    use_qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)
