"""The weights of ``granite_3_0_1b_a400m`` (``granite_3_0_1b_a400m.json``),
made on the device from a seed in one draw, under the names and in the
layouts of the port's decoder tree (``blocks.<g>.l0.mixer.wq`` (d, H, hd),
experts (E, d, f) and (E, f, d), the tied embedding (V, d)). Plain torch;
the reference reads the same leaves."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def leaves(config: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, scale) of every leaf; scale 0 for a norm scale
    (zeros, used as 1 + scale)."""
    m = config["model"]
    d, h, k, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    e, f, v = m["num_experts"], m["moe_d_ff"], m["vocab_size"]
    out = [("embed", (v, d), d ** -0.5), ("baseline", (d,), d ** -0.5)]
    for g in range(m["num_groups"]):
        p = f"blocks.{g}.l0."
        out += [(p + "pre_norm.scale", (d,), 0.0),
                (p + "mixer.wq", (d, h, hd), d ** -0.5),
                (p + "mixer.wk", (d, k, hd), d ** -0.5),
                (p + "mixer.wv", (d, k, hd), d ** -0.5),
                (p + "mixer.wo", (h, hd, d), (h * hd) ** -0.5),
                (p + "ffn_pre_norm.scale", (d,), 0.0),
                (p + "ffn.router", (d, e), d ** -0.5),
                (p + "ffn.wi", (e, d, f), d ** -0.5),
                (p + "ffn.wg", (e, d, f), d ** -0.5),
                (p + "ffn.wo", (e, f, d), f ** -0.5)]
    out.append(("final_norm.scale", (d,), 0.0))
    return out


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf a view of one normal draw on ``device`` (a generator
    there seeded with ``seed``), clamped to [-2, 2] and scaled; the norm
    scales zero."""
    specs = leaves(config)
    total = sum(math.prod(s) for _, s, scale in specs if scale)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    out, offset = {}, 0
    for name, shape, scale in specs:
        if not scale:
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[offset:offset + n].view(shape).mul_(scale)
        offset += n
    return out
