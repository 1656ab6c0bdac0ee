"""Feed-forward layers: SwiGLU (llama/qwen), GeGLU (gemma), GELU (musicgen).

Each product takes the activation to float32 against the float32 weight
and rounds the result to the activation's type, where the reference
rounds (its ``preferred_element_type=float32`` einsums).

Under a model axis of M (``common.use_rules``) that divides d_ff, a rank
computes its d_ff/M hidden units (``wi``/``wg`` split on their output
axis, ``wo`` on its input axis) and the output's partial sums are
all-reduced over the model group (Megatron's column- then row-parallel
pair)."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import (Params, copy_to_model, full_size,
                                       model_split, operand, param,
                                       reduce_from_model)

# the reference's logical axes of each leaf (its ``mlp_init``)
AXES = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"), "wo": ("mlp", "embed")}


def mlp_init(cfg, ffn, *, generator, device=None):
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device)
    if ffn in ("swiglu", "geglu"):
        return Params(wi=param((d, f), **kw), wg=param((d, f), **kw),
                      wo=param((f, d), **kw))
    if ffn == "gelu":
        return Params(wi=param((d, f), **kw), wo=param((f, d), **kw))
    raise ValueError(ffn)


def mlp_apply(params, x, ffn):
    split = model_split(full_size(params, "wi", 1)) > 1
    names = ("wi", "wo") if ffn == "gelu" else ("wi", "wg", "wo")
    w = {n: operand(params, n, (0 if n == "wo" else 1) if split else None)
         for n in names}
    xf = (copy_to_model(x) if split else x).float()
    h = (xf @ w["wi"]).to(x.dtype)
    if ffn == "swiglu":
        g = xf @ w["wg"]
        h = h * F.silu(g).to(x.dtype)
    elif ffn == "geglu":
        g = xf @ w["wg"]
        h = h * F.gelu(g, approximate="tanh").to(x.dtype)
    elif ffn == "gelu":
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    out = h.float() @ w["wo"]
    if split:
        out = reduce_from_model(out)
    return out.to(x.dtype)
