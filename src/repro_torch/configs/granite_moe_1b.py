"""Granite-3.0 1B-A400M [moe] — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

24L, d_model=1024, 16 heads (GQA kv=8, head_dim=64), expert d_ff=512,
vocab=49155. Tied embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    block_pattern=(("attn", "moe"),),
    num_groups=24,
    num_experts=32,
    num_experts_per_tok=8,
    moe_d_ff=512,
    tie_embeddings=True,
)
