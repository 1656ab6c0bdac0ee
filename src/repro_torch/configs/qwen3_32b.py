"""Qwen3-32B [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family card]

64L, d_model=5120, 64 heads (GQA kv=8, head_dim=128), d_ff=25600,
vocab=151936. Untied embeddings, RoPE theta 1e6.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B (family); Qwen3 technical report",
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    block_pattern=(("attn", "swiglu"),),
    num_groups=64,
    use_qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=False,
)
