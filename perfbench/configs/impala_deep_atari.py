"""The weights of ``impala_deep_atari`` (``impala_deep_atari.json``),
made on the device from a seed in one draw: each leaf under the name and
in the layout of the PyTorch module's ``state_dict`` (convolutions
(C_out, C_in, 3, 3), linears (out, in)). Plain torch; the reference
reads the same leaves."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def leaves(config: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, scale) of every leaf in ``state_dict`` order; scale 0
    for a bias (zeros)."""
    a = config["agent"]
    h, w, cin = a["obs_shape"]
    out: List[Tuple[str, tuple, float]] = []

    def conv(name, ci, co):
        out.append((name + ".weight", (co, ci, 3, 3), 1 / math.sqrt(9 * ci)))
        out.append((name + ".bias", (co,), 0.0))

    for i, ch in enumerate(a["channels"]):
        conv(f"sections.{i}.conv", cin, ch)
        for j in range(a["residual_blocks"]):
            conv(f"sections.{i}.res.{j}.c1", ch, ch)
            conv(f"sections.{i}.res.{j}.c2", ch, ch)
        cin = ch
        h, w = -(-h // 2), -(-w // 2)
    flat = h * w * cin
    for name, din, dout, scale in (
            ("fc", flat, a["fc"], 1 / math.sqrt(flat)),
            ("policy", a["fc"], a["num_actions"], 0.01),
            ("baseline", a["fc"], 1, 0.01)):
        out.append((name + ".weight", (dout, din), scale))
        out.append((name + ".bias", (dout,), 0.0))
    return out


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from one normal draw on ``device`` (a generator there
    seeded with ``seed``), clamped to [-2, 2] and scaled; biases zero."""
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
