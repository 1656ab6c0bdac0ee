"""Gemma-2 27B [dense] — local+global alternating attention, logit softcaps,
sandwich norms, GeGLU. [arXiv:2408.00118]

46L, d_model=4608, 32 heads (GQA kv=16, head_dim=128), d_ff=36864,
vocab=256000. Query scale = (d_model/num_heads)^-0.5 = 144^-0.5 (not
head_dim). Sliding window 4096 on local layers; tied embeddings with
sqrt(d) embedding scale.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    arch_type="dense",
    source="arXiv:2408.00118 (Gemma 2)",
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    block_pattern=(("local_attn", "geglu"), ("attn", "geglu")),
    num_groups=23,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    attn_scale=(4608 / 32) ** -0.5,
    sandwich_norm=True,
    embed_scale=True,
    tie_embeddings=True,
)
