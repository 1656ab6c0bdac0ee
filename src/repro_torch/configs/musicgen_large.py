"""MusicGen-Large [audio] — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284]

48L, d_model=2048, 32 heads (kv=32, head_dim=64), d_ff=8192 (GELU),
vocab=2048 (EnCodec codebook size). LayerNorm + sinusoidal positions.
The EnCodec tokenizer is the stubbed modality frontend: input_specs()
provides token ids; the 4-codebook delay interleave is flattened to a
single stream (DESIGN.md §5/§10).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    source="arXiv:2306.05284 (MusicGen)",
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=(("attn", "gelu"),),
    num_groups=48,
    norm="layernorm",
    pos_emb="sinusoidal",
    tie_embeddings=False,
)
