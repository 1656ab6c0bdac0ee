"""Mamba2 mixer (SSD, state-space duality, in its chunked matmul form).

Shapes: x (B,S,d); d_inner = expand * d; H = d_inner / headdim heads of
P = headdim; N = ssm_state. One B/C group (n_groups = 1), shared by every
head.

Projections follow the reference's mixed precision: the activation (bf16 on
the serving path) meets the float32 weight in a float32 product and the
result is rounded to the activation's type; the depthwise convolution, the
SSD chunks and the state are float32.

``mamba_apply`` runs the sequence chunk by chunk, each chunk either as the
reference's einsum math (``ssd_impl="xla"``, plain PyTorch here) or on the
SSD chunk kernel (``"kernel"``: the CUDA kernel on the card, its plain
version for CPU tensors, with the plain version's VJP as its backward, as
the reference's ``ssd_chunk_trainable``), and carries the (B,H,P,N) state
between chunks.
As in the reference, a sequence longer than one chunk must be a multiple of
it. ``mamba_decode`` is the one-token recurrence; it writes the new conv
window and state into the cache in place.

Under a model axis of M (``common.use_rules``) that divides the head
count, a rank runs H/M heads: ``in_proj_z`` / ``in_proj_x`` /
``in_proj_dt`` split on their output axis, ``dt_bias`` / ``a_log`` /
``d_skip`` / ``norm`` on theirs, ``out_proj`` on its input axis (its
partial sums all-reduced), and the SSD chunk kernel on those heads.
``in_proj_bc`` (no rule: the rules split its ``embed`` axis instead) is
used whole, so every rank computes the one B/C group its heads share. The
gated norm runs over all of d_inner, so its sum of squares is summed over
the model group. ``conv_w`` / ``conv_b`` are split by the rules
contiguously over their d_inner + 2N channels, which does not follow the
x | B C layout: each use gathers them whole (they are small) and takes
this rank's x channels and every B/C channel. The decode cache holds the
conv window of those channels and the state of the local heads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import (Params, copy_to_model, local_slice,
                                       model_split, operand, param,
                                       reduce_from_model, rmsnorm,
                                       split_rmsnorm)

# the reference's logical axes of each leaf (its ``mamba_init``)
AXES = {"in_proj_z": ("embed", "mlp"), "in_proj_x": ("embed", "mlp"),
        "in_proj_bc": ("embed", "ssm_state2"),
        "in_proj_dt": ("embed", "ssm_heads"),
        "conv_w": ("conv_width", "conv_ch"), "conv_b": ("conv_ch",),
        "dt_bias": ("ssm_heads",), "a_log": ("ssm_heads",),
        "d_skip": ("ssm_heads",), "norm": ("mlp",),
        "out_proj": ("mlp", "embed")}


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_head_dim, cfg.ssm_state


def mamba_init(cfg, *, generator, device=None):
    """Params for one Mamba2 layer."""
    d = cfg.d_model
    d_in, nh, _, n = _dims(cfg)
    w = cfg.ssm_conv_width
    conv_ch = d_in + 2 * n
    kw = dict(generator=generator, device=device)
    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba default)
    u = torch.rand((nh,), generator=generator, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))      # inverse softplus

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    return Params(
        in_proj_z=param((d, d_in), **kw),
        in_proj_x=param((d, d_in), **kw),
        in_proj_bc=param((d, 2 * n), **kw),
        in_proj_dt=param((d, nh), **kw),
        conv_w=param((w, conv_ch), scale=w ** -0.5, **kw),
        conv_b=param((conv_ch,), init="zeros", **kw),
        dt_bias=dt_bias,
        a_log=ones((nh,)),
        d_skip=ones((nh,)),
        norm=param((d_in,), init="zeros", **kw),
        out_proj=param((d_in, d), **kw))


def _conv1d(x, w, b, state=None):
    """Causal depthwise conv. x: (B,S,C); w: (W,C); state: (B,W-1,C) or
    None. Returns (silu(conv + b) in float32, the last W-1 inputs in x's
    type)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(width))
    return F.silu(y + b), xp[:, xp.shape[1] - (width - 1):]


def _segsum(a):
    """a: (..., L) -> (..., L, L) lower-triangular segment sums:
    out[l, s] = a[s+1] + ... + a[l], -inf above the diagonal."""
    n = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -math.inf)


def head_split(cfg) -> int:
    """How many parts the active model axis splits the heads into."""
    return model_split(_dims(cfg)[1])


def _local_dims(cfg):
    """``_dims`` of this rank's share: d_inner and the heads divided by
    ``head_split``."""
    d_in, nh, p, n = _dims(cfg)
    parts = head_split(cfg)
    return d_in // parts, nh // parts, p, n


def _weights(params, cfg):
    """The layer's leaves as this rank computes with them (all of them
    outside a model-parallel context), and whether its heads are split."""
    split = head_split(cfg) > 1
    if not split:
        return {name: operand(params, name) for name in AXES}, False
    w = {name: operand(params, name, 1) for name in
         ("in_proj_z", "in_proj_x", "in_proj_dt")}
    w.update({name: operand(params, name, 0) for name in
              ("dt_bias", "a_log", "d_skip", "norm", "out_proj")})
    w["in_proj_bc"] = operand(params, "in_proj_bc")
    d_in = _dims(cfg)[0]
    for name in ("conv_w", "conv_b"):
        full = operand(params, name, local=True)
        dim = full.dim() - 1
        w[name] = torch.cat([local_slice(full.narrow(dim, 0, d_in), dim),
                             full.narrow(dim, d_in, full.shape[dim] - d_in)],
                            dim=dim)
    return w, True


def _in_proj(params, x, split=False):
    """z, x, bc in x's type and dt in float32, each a float32 product.
    With ``split``, z, x and dt are this rank's and bc, which its heads
    share with the others', enters their work behind ``copy_to_model``."""
    xf = x.float()
    xl = copy_to_model(x).float() if split else xf
    z = (xl @ params["in_proj_z"]).to(x.dtype)
    xs = (xl @ params["in_proj_x"]).to(x.dtype)
    bc = (xf @ params["in_proj_bc"]).to(x.dtype)
    if split:
        bc = copy_to_model(bc)
    return z, xs, bc, xl @ params["in_proj_dt"]


def _out(params, y, z, x_dtype, cfg, split=False):
    """Gate by silu(z), normalise, project out; y and z in the activation
    type. With ``split`` they are this rank's channels: the norm's sum of
    squares and the projection's partial sums are summed over the model
    group."""
    g = y * F.silu(z.float()).to(x_dtype)
    if not split:
        y = rmsnorm({"scale": params["norm"]}, g, cfg.norm_eps)
        return (y.float() @ params["out_proj"]).to(x_dtype)
    y = split_rmsnorm(params["norm"], g, _dims(cfg)[0], cfg.norm_eps)
    return reduce_from_model(y.float() @ params["out_proj"]).to(x_dtype)


def _chunk_xla(c, b, x, da, h):
    """The reference's einsum math for one chunk. c, b (B,L,N); x (B,L,H,P)
    (dt-weighted); da (B,L,H); h (B,H,P,N). Returns (y (B,L,H,P), h_new)."""
    acs = torch.cumsum(da, dim=1)                               # (B,L,H)
    lmat = torch.exp(_segsum(da.transpose(1, 2)))               # (B,H,L,L)
    y_diag = torch.einsum("bln,bsn,bhls,bshp->blhp", c, b, lmat, x)
    decay_states = torch.exp(acs[:, -1:, :] - acs)              # (B,L,H)
    new_state = torch.einsum("bln,blh,blhp->bhpn", b, decay_states, x)
    y_off = torch.einsum("bln,blh,bhpn->blhp", c, torch.exp(acs), h)
    h_new = h * torch.exp(acs[:, -1, :])[..., None, None] + new_state
    return y_diag + y_off, h_new


def mamba_apply(params, x, cfg, state=None, return_state=False, impl=None):
    """Full-sequence (chunked) Mamba2. x: (B,S,d).

    state: optional {conv (B,W-1,C), ssm (B,H,P,N)} to continue from.
    impl: ``xla`` (the reference's einsum chunk math) or ``kernel`` (the
    SSD chunk kernel, one launch per chunk); defaults to ``cfg.ssd_impl``.
    S must be at most ``cfg.ssm_chunk`` or a multiple of it, as in the
    reference. Returns (y, new_state | None)."""
    impl = impl or cfg.ssd_impl
    if impl not in ("xla", "kernel"):
        raise ValueError(f"unknown ssd impl {impl}")
    bsz, s, _ = x.shape
    params, split = _weights(params, cfg)
    d_in, nh, p, n = _local_dims(cfg)
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        raise ValueError(f"Mamba2 sequence length {s} is neither at most the "
                         f"chunk {cfg.ssm_chunk} nor a multiple of it")

    z, xs, bc, dt = _in_proj(params, x, split)
    conv_out, new_conv = _conv1d(
        torch.cat([xs, bc], dim=-1), params["conv_w"], params["conv_b"],
        None if state is None else state["conv"])
    xs, bmat, cmat = torch.split(conv_out, [d_in, n, n], dim=-1)
    dt = F.softplus(dt + params["dt_bias"])                    # (B,S,H)
    da = dt * -torch.exp(params["a_log"].float())              # <= 0

    xh = xs.reshape(bsz, s, nh, p).float()
    xw = xh * dt[..., None]                                    # dt-weighted
    bmat, cmat = bmat.float(), cmat.float()
    h = (torch.zeros((bsz, nh, p, n), dtype=torch.float32, device=x.device)
         if state is None else state["ssm"].float())
    ys = []
    for i in range(0, s, chunk):
        args = (cmat[:, i:i + chunk], bmat[:, i:i + chunk],
                xw[:, i:i + chunk], da[:, i:i + chunk], h)
        y_i, h = (kops.ssd_chunk_trainable(*args) if impl == "kernel"
                  else _chunk_xla(*args))
        ys.append(y_i)
    y = torch.cat(ys, dim=1) + params["d_skip"][None, None, :, None] * xh
    out = _out(params, y.reshape(bsz, s, d_in).to(x.dtype), z, x.dtype, cfg,
               split)
    if return_state:
        return out, {"conv": new_conv, "ssm": h}
    return out, None


def mamba_cache_init(cfg, batch, dtype, device=None):
    d_in, nh, p, n = _local_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_in + 2 * n),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, p, n), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(params, x, cache, cfg):
    """Single-token step. x: (B,1,d). The new conv window and state are
    written into ``cache`` in place and the same dict is returned.
    Returns (y (B,1,d), cache)."""
    bsz = x.shape[0]
    params, split = _weights(params, cfg)
    d_in, nh, p, n = _local_dims(cfg)
    z, xs, bc, dt = _in_proj(params, x, split)
    conv_out, new_conv = _conv1d(torch.cat([xs, bc], dim=-1),
                                 params["conv_w"], params["conv_b"],
                                 cache["conv"])
    xs, bmat, cmat = torch.split(conv_out, [d_in, n, n], dim=-1)
    dt = F.softplus(dt + params["dt_bias"])[:, 0]              # (B,H)
    dec = torch.exp(dt * -torch.exp(params["a_log"].float()))

    xh = xs[:, 0].reshape(bsz, nh, p).float()
    bv = bmat[:, 0].float()                                    # (B,N)
    cv = cmat[:, 0].float()
    h = cache["ssm"] * dec[..., None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", xh, bv, dt)
    y = torch.einsum("bhpn,bn->bhp", h, cv)
    y = y + params["d_skip"][None, :, None] * xh
    out = _out(params, y.reshape(bsz, 1, d_in).to(x.dtype), z, x.dtype, cfg,
               split)
    cache["conv"].copy_(new_conv)
    cache["ssm"].copy_(h)
    return out, cache
