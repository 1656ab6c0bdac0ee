"""Model FLOPs of the decoder of ``granite_3_0_1b_a400m`` (any config of
its shape: attention and MoE layers, a tied head), 2 a multiply-add, the
matmuls the model needs and nothing the implementation adds: per token
and layer the q, k, v and output projections, the router, and the
SwiGLU FFNs of its top-k experts only (not the dispatch and combine
products); q k^T and P V over the causal span the inputs need; the LM
head over the vocabulary and the value head. ``mfu.lm`` reads these;
remat's recompute is not counted."""

from __future__ import annotations


def per_token(m: dict) -> float:
    d, h, kh, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    layer = 2 * (d * h * hd + 2 * d * kh * hd + h * hd * d) \
        + 2 * d * m["num_experts"] \
        + m["num_experts_per_tok"] * 3 * 2 * d * m["moe_d_ff"]
    return float(m["num_groups"] * layer + 2 * d * m["vocab_size"] + 2 * d)


def forward_flops(m: dict, b: int, s: int) -> float:
    """A forward pass over (b, s) tokens, causal."""
    pairs = s * (s + 1) // 2
    attn = 4.0 * b * m["num_heads"] * m["head_dim"] * pairs \
        * m["num_groups"]
    return b * s * per_token(m) + attn


def generation_flops(m: dict, b: int, t: int) -> float:
    """Generating t tokens a row after a one-token prompt: the prompt's
    prefill and t - 1 decode steps, each position attending to itself
    and the positions before it: the forward pass over (b, t)."""
    return forward_flops(m, b, t)
