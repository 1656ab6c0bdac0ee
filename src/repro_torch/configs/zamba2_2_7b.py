"""Zamba2-2.7B [hybrid] — Mamba2 backbone + weight-shared attention block.
[arXiv:2411.15242]

54 Mamba2 blocks, d_model=2560, ssm_state=64; one shared attention+MLP
block (32 heads, d_ff=10240) applied after every 6 Mamba blocks (same
weights each time — Zamba's global memory block). vocab=32000.
Per-invocation LoRA adapters on the shared block are omitted (DESIGN.md §10).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    source="arXiv:2411.15242 (Zamba2)",
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=(("mamba", "none"),) * 6,
    num_groups=9,
    shared_attn_every=6,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)
