"""DeepSeek-Coder-33B [dense] — llama-arch. [arXiv:2401.14196]

62L, d_model=7168, 56 heads (GQA kv=8, head_dim=128), d_ff=19200,
vocab=32256. RoPE theta 1e5 (DeepSeek-Coder long-context base).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    source="arXiv:2401.14196 (DeepSeek-Coder)",
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    block_pattern=(("attn", "swiglu"),),
    num_groups=62,
    rope_theta=1e5,
    tie_embeddings=False,
)
