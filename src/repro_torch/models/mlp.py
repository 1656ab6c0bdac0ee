"""Feed-forward layers: SwiGLU (llama/qwen), GeGLU (gemma), GELU (musicgen).

Each product takes the activation to float32 against the float32 weight
and rounds the result to the activation's type, where the reference
rounds (its ``preferred_element_type=float32`` einsums)."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import Params, param


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
    xf = x.float()
    h = (xf @ params["wi"]).to(x.dtype)
    if ffn == "swiglu":
        g = xf @ params["wg"]
        h = h * F.silu(g).to(x.dtype)
    elif ffn == "geglu":
        g = xf @ params["wg"]
        h = h * F.gelu(g, approximate="tanh").to(x.dtype)
    elif ffn == "gelu":
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return (h.float() @ params["wo"]).to(x.dtype)
