"""Shared decoder building blocks: the parameter tree, initialisers, norms,
rotary and sinusoidal position embeddings, softcap.

The reference keeps a decoder's parameters as nested dicts of arrays. Here
the same tree is a tree of :class:`Params` modules: each node holds named
``nn.Parameter`` leaves and child nodes, read with ``[]`` as the
reference's dicts are, so ``params["mixer"]["wq"]`` reads the same in both
packages. Leaves keep the reference's layouts (``wq`` as (d, H, hd), ``wo``
as (H, hd, d)), and a node's ``state_dict`` names each leaf by its path.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint
from torch import nn


class Params(nn.Module):
    """One node of a parameter tree: tensors become ``nn.Parameter``
    leaves, modules become child nodes, both addressed by name."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            if isinstance(child, nn.Module):
                self.add_module(name, child)
            else:
                self.register_parameter(name, nn.Parameter(child))

    def __getitem__(self, name):
        return getattr(self, name)


def param(shape, *, generator, device=None, scale=None, init="normal"):
    """A float32 leaf. ``normal``: truncated normal on [-2, 2] times
    ``scale`` (default 1/sqrt(shape[0]), the fan-in); ``zeros``: zeros
    (norm scales, used as ``1 + scale``); ``ones``: ones (the mLSTM's
    forget-gate bias)."""
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if scale is None:
        scale = 1.0 / math.sqrt(max(1, shape[0]))
    v = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return v.mul_(scale)


def remat_active(cfg, build_cache=False) -> bool:
    """Whether a full-sequence pass checkpoints its regions: the config
    asks for it (``cfg.remat``, the reference's ``jax.checkpoint``), no
    decode cache is being built, and autograd is recording."""
    return cfg.remat and not build_cache and torch.is_grad_enabled()


def remat(fn, *args):
    """``fn(*args)`` as one checkpoint region (non-reentrant): its
    intermediates are dropped after the forward pass and recomputed in the
    backward pass, which runs ``fn`` (and its kernels) a second time."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim, *, device=None):
    return Params(scale=param((dim,), generator=None, device=device,
                              init="zeros"))


def rmsnorm(params, x, eps=1e-6):
    """RMSNorm with the (1 + scale) parameterisation (gemma/qwen style),
    float32 statistics, result in x's type."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dt)


def layernorm_init(dim, *, device=None):
    return Params(
        scale=param((dim,), generator=None, device=device, init="zeros"),
        bias=param((dim,), generator=None, device=device, init="zeros"))


def layernorm(params, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * (1.0 + params["scale"].float()) + params["bias"].float()
    return y.to(dt)


def make_norm(cfg):
    """(init, apply) of the config's norm, ``apply(params, x)``."""
    if cfg.norm == "layernorm":
        return layernorm_init, lambda p, x: layernorm(p, x, cfg.norm_eps)
    return rmsnorm_init, lambda p, x: rmsnorm(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim, theta, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). The two
    halves of hd rotate together (split halves, not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs   # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]             # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(positions, dim):
    """(..., S) int -> (..., S, dim) float32 sinusoidal embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].float() * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def softcap(x, cap):
    return cap * torch.tanh(x / cap)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of nested dicts (a decode cache),
    with the matching leaves of ``rest`` as further arguments; returns the
    tree of results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)
