"""xLSTM-125M [ssm] — alternating mLSTM + sLSTM blocks. [arXiv:2405.04517]

12L, d_model=768, 4 heads, d_ff=0 (projections live inside the xLSTM
blocks), vocab=50304. No position embedding (recurrence carries order).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    source="arXiv:2405.04517 (xLSTM)",
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(("mlstm", "none"), ("slstm", "none")),
    num_groups=6,
    pos_emb="none",
    tie_embeddings=True,
)
