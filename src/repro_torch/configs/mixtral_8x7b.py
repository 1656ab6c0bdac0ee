"""Mixtral 8x7B [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]

32L, d_model=4096, 32 heads (GQA kv=8, head_dim=128), expert d_ff=14336,
vocab=32000, window 4096, RoPE theta 1e6.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    source="arXiv:2401.04088 (Mixtral of Experts)",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=(("swa_attn", "moe"),),
    num_groups=32,
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    rope_theta=1e6,
    tie_embeddings=False,
)
