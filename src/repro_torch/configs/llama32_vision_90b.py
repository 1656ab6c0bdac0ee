"""Llama-3.2-Vision-90B [vlm] — self-attention decoder with cross-attention
image layers every 5th layer. [hf:meta-llama/Llama-3.2-11B-Vision family]

100L (80 self + 20 cross), d_model=8192, 64 heads (GQA kv=8, head_dim=128),
d_ff=28672, vocab=128256. The ViT vision encoder + projector are stubbed:
input_specs() provides precomputed patch embeddings (B, 6144, d_model)
consumed by the cross-attention layers (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision (family card)",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=(
        ("attn", "swiglu"), ("attn", "swiglu"), ("attn", "swiglu"),
        ("attn", "swiglu"), ("xattn", "swiglu"),
    ),
    num_groups=20,
    vision_seq=6144,  # ~4x1601 patches rounded to the 1024-chunk grid (DESIGN.md §10)
    rope_theta=5e5,
    tie_embeddings=False,
)
