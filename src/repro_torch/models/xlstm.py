"""xLSTM mixers: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, a sequential recurrence) [arXiv:2405.04517].

mLSTM runs the chunkwise-parallel form: quadratic products inside a chunk
of ``cfg.xlstm_chunk`` tokens and the recurrent state (C, n, m) carried
from chunk to chunk. As in the reference, a sequence longer than one chunk
must be a multiple of it (``ValueError`` here, where the reference
asserts). The reference checkpoints each chunk (``jax.checkpoint``) to
save memory only; at xLSTM-125M's widths one chunk's (B, L, L, H) decay
matrix is a few hundred KB, so the port keeps no checkpoint region inside
the mixer (``cfg.remat`` still checkpoints each layer and group, in
``blocks.py`` and ``model.py``). sLSTM is a true recurrence, hidden state
fed back through the gates: one ``_slstm_step`` a token, in order.

Precision, as the reference's: q, k, v and the gate pre-activations are
float32 products of the activation with the float32 weights, and stay
float32; the chunk arithmetic, the sLSTM recurrence and the state are
float32 whatever the model's dtype. The mixer's output is rounded to the
activation's type before the RMSNorm (mLSTM: before the output gate;
sLSTM: after ``u1 * silu(u2)`` too).

State conventions (float32; keys in the order of the reference's pytrees):
  mLSTM: C (B,H,dk,dv), m (B,H), n (B,H,dk)     [log-space stabiliser m]
  sLSTM: c, h, m, n (B,H,dh)
The decode functions write the new state into the dict they are given,
in place, and return it, as ``mamba.mamba_decode`` does with its cache.

Under a model axis of M that divides the heads (``head_split``; the
reference's rules split ``heads`` and, by its ``fallback_model``, the
rows of ``wo_gate`` and ``wo``), a rank runs the recurrence of its H/M
heads and keeps their float32 state, and its d/M channels are exactly
those heads' dh blocks:

  mLSTM  q, k, v and the gates from the rank's columns of ``wq`` / ``wk``
         / ``wv`` / ``wi`` / ``wf``; the output gate ``x @ wo_gate`` from
         its rows, a partial sum reduced over the model group before the
         silu; the norm over the whole d, its sum of squares summed over
         the group; ``wo`` row-parallel, its partial sums reduced.
  sLSTM  the gates from its heads of ``wx`` / ``wr`` / ``b``; the norm as
         mLSTM's, then the normalised channels gathered for ``up``, which
         runs column-parallel on the rank's columns of u1 and of u2 (so
         ``u1 * silu(u2)`` is local); ``down`` row-parallel.

Otherwise the mixer runs whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (Params, copy_to_model, gather_model,
                                       local_slice, model_split, operand,
                                       param, reduce_from_model, rmsnorm,
                                       split_rmsnorm, sum_over_model)


# the reference's logical axes of each leaf (its ``mlstm_init`` and
# ``slstm_init``): the spec tables of ``--mesh-model``
MLSTM_AXES = {"wq": ("embed", "heads", "head_dim"),
              "wk": ("embed", "heads", "head_dim"),
              "wv": ("embed", "heads", "head_dim"),
              "wi": ("embed", "heads"), "wf": ("embed", "heads"),
              "bf": ("heads",), "wo_gate": ("embed", "embed2"),
              "norm": ("embed",), "wo": ("embed", "embed2")}
SLSTM_AXES = {"wx": ("embed", "gates", "heads", "head_dim"),
              "wr": ("gates", "heads", "head_dim", "head_dim2"),
              "b": ("gates", "heads", "head_dim"), "norm": ("embed",),
              "up": ("embed", "mlp"), "down": ("mlp", "embed")}

def _dims(cfg):
    h = cfg.num_heads
    return h, cfg.d_model // h


def head_split(cfg) -> int:
    """How many parts the active model axis splits the heads into: M where
    it divides them and the d channels are exactly the heads' dh blocks,
    else 1 (the mixer runs whole)."""
    h, dh = _dims(cfg)
    parts = model_split(h)
    return parts if h * dh == cfg.d_model else 1


def _local_dims(cfg):
    """This rank's heads and the head width."""
    h, dh = _dims(cfg)
    return h // head_split(cfg), dh


def _f32(x, w, spec):
    """A float32 product of the activation and a float32 weight."""
    return torch.einsum(spec, x.float(), w)


def _write(state, new):
    for k, v in new.items():
        state[k].copy_(v)
    return state


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(cfg, *, generator, device=None):
    """Params for one mLSTM layer."""
    d = cfg.d_model
    h, dh = _dims(cfg)
    kw = dict(generator=generator, device=device)
    return Params(
        wq=param((d, h, dh), **kw), wk=param((d, h, dh), **kw),
        wv=param((d, h, dh), **kw),
        wi=param((d, h), scale=d ** -0.5, **kw),
        wf=param((d, h), scale=d ** -0.5, **kw),
        bf=param((h,), init="ones", **kw),          # forget bias > 0
        wo_gate=param((d, d), **kw),
        norm=param((d,), init="zeros", **kw),
        wo=param((d, d), **kw))


def _mlstm_weights(params, cfg):
    """The layer's leaves as this rank computes with them, and whether
    its heads are split (module docstring)."""
    if head_split(cfg) == 1:
        return {n: operand(params, n) for n in MLSTM_AXES}, False
    w = {n: operand(params, n, 1) for n in ("wq", "wk", "wv", "wi", "wf")}
    w.update({n: operand(params, n, 0)
              for n in ("bf", "wo_gate", "norm", "wo")})
    return w, True


def _mlstm_qkvif(w, x):
    """q, k, v (B,S,H,dh) and the input / forget pre-activations (B,S,H),
    all float32 (H this rank's heads under a split)."""
    q = _f32(x, w["wq"], "bsd,dhe->bshe")
    k = _f32(x, w["wk"], "bsd,dhe->bshe")
    v = _f32(x, w["wv"], "bsd,dhe->bshe")
    i_pre = _f32(x, w["wi"], "bsd,dh->bsh")
    f_pre = _f32(x, w["wf"], "bsd,dh->bsh") + w["bf"]
    return q, k, v, i_pre, f_pre


def mlstm_state_init(cfg, batch, device=None):
    h, dh = _local_dims(cfg)
    z = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, dh, dh), **z),
            "m": torch.zeros((batch, h), **z),
            "n": torch.zeros((batch, h, dh), **z)}


def _mlstm_out(w, x, xc, y, cfg, split):
    """The output gate, norm and projection of the (B,S,d) float32 cell
    output ``y`` (this rank's d/M channels under ``split``; ``xc`` the
    input behind ``copy_to_model``)."""
    y = y.to(x.dtype)
    if not split:
        gate = F.silu(_f32(x, w["wo_gate"], "bsd,de->bse"))
        y = rmsnorm({"scale": w["norm"]}, y, cfg.norm_eps) \
            * gate.to(x.dtype)
        return _f32(y, w["wo"], "bse,ed->bsd").to(x.dtype)
    partial = _f32(local_slice(xc, -1), w["wo_gate"], "bsd,de->bse")
    gate = local_slice(F.silu(sum_over_model(partial)), -1)
    y = split_rmsnorm(w["norm"], y, cfg.d_model, cfg.norm_eps) \
        * gate.to(x.dtype)
    return reduce_from_model(_f32(y, w["wo"], "bse,ed->bsd")).to(x.dtype)


def _mlstm_chunk(carry, q_i, k_i, v_i, i_i, lf_i, scale):
    """One chunk: the outputs of its L tokens and the state at its end.
    q_i, k_i, v_i (B,L,H,dh); i_i, lf_i (B,L,H); carry (C, n, m)."""
    C, n, m = carry
    L = q_i.shape[1]
    F_ = torch.cumsum(lf_i, dim=1)                              # (B,L,H)
    # log-weight of input s for output l (s <= l): F_l - F_s + i_s
    dmat = F_[:, :, None, :] - F_[:, None, :, :] + i_i[:, None, :, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=q_i.device))[None, :, :, None]
    dmat = torch.where(mask, dmat, -torch.inf)                  # (B,L,S,H)
    # the state's log-weight at l: m + F_l
    state_w = m[:, None, :] + F_                                # (B,L,H)
    m_loc = torch.maximum(dmat.amax(dim=2), state_w)            # (B,L,H)
    dexp = torch.exp(dmat - m_loc[:, :, None, :])               # (B,L,S,H)
    sw = torch.exp(state_w - m_loc)                             # (B,L,H)

    logits = torch.einsum("blhe,bshe->blsh", q_i, k_i) * scale
    num_intra = torch.einsum("blsh,bshe->blhe", logits * dexp, v_i)
    num_state = torch.einsum("blhe,bhef->blhf", q_i * scale, C) \
        * sw[..., None]
    den_intra = torch.einsum("blsh,bshe->blhe", dexp, k_i)
    den = torch.einsum("blhe,blhe->blh", q_i * scale, den_intra) \
        + torch.einsum("blhe,bhe->blh", q_i * scale, n) * sw
    num = num_intra + num_state
    hout = num / torch.maximum(torch.abs(den),
                               torch.exp(-m_loc))[..., None]

    # the state at the end of the chunk
    b_last = F_[:, -1, :]                                       # (B,H)
    in_w = b_last[:, None, :] - F_ + i_i                        # (B,L,H)
    m_new = torch.maximum(m + b_last, in_w.amax(dim=1))         # (B,H)
    kv_w = torch.exp(in_w - m_new[:, None, :])                  # (B,L,H)
    decay = torch.exp(m + b_last - m_new)
    C_new = C * decay[..., None, None] + \
        torch.einsum("blh,blhe,blhf->bhef", kv_w, k_i, v_i)
    n_new = n * decay[..., None] + torch.einsum("blh,blhe->bhe", kv_w, k_i)
    return (C_new, n_new, m_new), hout


def mlstm_apply(params, x, cfg, state=None, return_state=False):
    """Chunkwise-parallel mLSTM. x: (B,S,d); S at most ``cfg.xlstm_chunk``
    or a multiple of it. state: optional {C, n, m} to continue from.
    Returns (y (B,S,d), state | None)."""
    b, s, d = x.shape
    _, dh = _dims(cfg)
    L = min(cfg.xlstm_chunk, s)
    if s % L:
        raise ValueError(f"mLSTM sequence length {s} is neither at most the "
                         f"chunk {cfg.xlstm_chunk} nor a multiple of it")
    w, split = _mlstm_weights(params, cfg)
    xc = copy_to_model(x) if split else x
    q, k, v, i_pre, f_pre = _mlstm_qkvif(w, xc)
    lf = F.logsigmoid(f_pre)                                    # (B,S,H)
    st = state if state is not None else mlstm_state_init(cfg, b, x.device)
    carry = (st["C"], st["n"], st["m"])
    ys = []
    for c in range(0, s, L):
        carry, hout = _mlstm_chunk(
            carry, q[:, c:c + L], k[:, c:c + L], v[:, c:c + L],
            i_pre[:, c:c + L], lf[:, c:c + L], dh ** -0.5)
        ys.append(hout)
    y = torch.cat(ys, dim=1).reshape(b, s, -1)
    out = _mlstm_out(w, x, xc, y, cfg, split)
    if return_state:
        C, n, m = carry
        return out, {"C": C, "m": m, "n": n}
    return out, None


def mlstm_decode(params, x, state, cfg):
    """Single-token mLSTM step. x: (B,1,d). The new state is written into
    ``state`` in place. Returns (y (B,1,d), state)."""
    b = x.shape[0]
    _, dh = _dims(cfg)
    scale = dh ** -0.5
    w, split = _mlstm_weights(params, cfg)
    xc = copy_to_model(x) if split else x
    q, k, v, i_pre, f_pre = _mlstm_qkvif(w, xc)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                         # (B,H,dh)
    i_t, lf = i_pre[:, 0], F.logsigmoid(f_pre[:, 0])            # (B,H)

    m_new = torch.maximum(lf + state["m"], i_t)
    fw = torch.exp(lf + state["m"] - m_new)[..., None]
    iw = torch.exp(i_t - m_new)[..., None]
    C = state["C"] * fw[..., None] + iw[..., None] * \
        torch.einsum("bhe,bhf->bhef", k, v)
    n = state["n"] * fw + iw * k
    num = torch.einsum("bhe,bhef->bhf", q * scale, C)
    den = torch.abs(torch.einsum("bhe,bhe->bh", q * scale, n))
    hout = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    out = _mlstm_out(w, x, xc, hout.reshape(b, 1, -1), cfg, split)
    return out, _write(state, {"C": C, "m": m_new, "n": n})


def mlstm_reference(params, x, cfg, state=None):
    """The sequential oracle: ``mlstm_decode`` token by token over S (on a
    copy of ``state``). Returns (y (B,S,d), state)."""
    b = x.shape[0]
    st = ({k: v.clone() for k, v in state.items()} if state is not None
          else mlstm_state_init(cfg, b, x.device))
    ys = []
    for t in range(x.shape[1]):
        y, st = mlstm_decode(params, x[:, t:t + 1], st, cfg)
        ys.append(y)
    return torch.cat(ys, dim=1), st


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(cfg, *, generator, device=None):
    """Params for one sLSTM layer."""
    d = cfg.d_model
    h, dh = _dims(cfg)
    kw = dict(generator=generator, device=device)
    return Params(
        # input projections of the gates z, i, f, o
        wx=param((d, 4, h, dh), **kw),
        # per-head (block-diagonal) recurrent weights
        wr=param((4, h, dh, dh), scale=dh ** -0.5, **kw),
        b=param((4, h, dh), init="zeros", **kw),
        norm=param((d,), init="zeros", **kw),
        up=param((d, 2 * d), **kw),
        down=param((d, d), **kw))


def slstm_state_init(cfg, batch, device=None):
    h, dh = _local_dims(cfg)
    return {k: torch.zeros((batch, h, dh), dtype=torch.float32,
                           device=device) for k in ("c", "h", "m", "n")}


def _slstm_weights(params, cfg):
    """The layer's leaves as this rank computes with them, and whether
    its heads are split: under a split, ``up`` is this rank's columns of
    u1 followed by its columns of u2 (module docstring)."""
    if head_split(cfg) == 1:
        return {n: operand(params, n) for n in SLSTM_AXES}, False
    w = {"wx": operand(params, "wx", 2), "wr": operand(params, "wr", 1),
         "b": operand(params, "b", 1), "norm": operand(params, "norm", 0),
         "down": operand(params, "down", 0)}
    d = cfg.d_model
    up = operand(params, "up", local=True)
    w["up"] = torch.cat([local_slice(up.narrow(1, 0, d), 1),
                         local_slice(up.narrow(1, d, d), 1)], dim=1)
    return w, True


def _slstm_step(w, xt, st):
    """xt: (B,4,H,dh) the gates' projected input; st: the state dict.
    Returns the new state (a new dict)."""
    rec = torch.einsum("bhe,ghef->bghf", st["h"], w["wr"])
    g = xt + rec + w["b"]                                       # (B,4,H,dh)
    z_pre, i_pre, f_pre, o_pre = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    lf = F.logsigmoid(f_pre)
    m_new = torch.maximum(lf + st["m"], i_pre)
    fw = torch.exp(lf + st["m"] - m_new)
    iw = torch.exp(i_pre - m_new)
    c = fw * st["c"] + iw * z
    n = fw * st["n"] + iw
    hout = o * c / torch.clamp(n, min=1e-6)
    return {"c": c, "h": hout, "m": m_new, "n": n}


def _slstm_out(w, x, hs, cfg, split):
    """The norm, gated up-projection and down-projection of the (B,S,d)
    float32 hidden states ``hs`` (this rank's channels under ``split``:
    normalised over the whole d, then gathered for ``up``)."""
    if not split:
        y = rmsnorm({"scale": w["norm"]}, hs.to(x.dtype), cfg.norm_eps)
    else:
        y = split_rmsnorm(w["norm"], hs.to(x.dtype), cfg.d_model,
                          cfg.norm_eps)
        y = copy_to_model(gather_model(y, -1))
    u1, u2 = torch.chunk(_f32(y, w["up"], "bsd,de->bse"), 2, dim=-1)
    y = (u1 * F.silu(u2)).to(x.dtype)
    out = _f32(y, w["down"], "bse,ed->bsd")
    return (reduce_from_model(out) if split else out).to(x.dtype)


def _slstm_gates(w, x, split):
    """The gates' projected input (B,S,4,H,dh), float32."""
    xc = copy_to_model(x) if split else x
    return _f32(xc, w["wx"], "bsd,dghe->bsghe")


def slstm_apply(params, x, cfg, state=None, return_state=False):
    """Sequential sLSTM. x: (B,S,d); state: optional {c, n, h, m}.
    Returns (y (B,S,d), state | None)."""
    b, s, d = x.shape
    st = state if state is not None else slstm_state_init(cfg, b, x.device)
    w, split = _slstm_weights(params, cfg)
    xg = _slstm_gates(w, x, split)                              # (B,S,4,H,dh)
    hs = []
    for t in range(s):
        st = _slstm_step(w, xg[:, t], st)
        hs.append(st["h"])
    out = _slstm_out(w, x, torch.stack(hs, dim=1).reshape(b, s, -1), cfg,
                     split)
    return out, (st if return_state else None)


def slstm_decode(params, x, state, cfg):
    """Single-token sLSTM step. x: (B,1,d). The new state is written into
    ``state`` in place. Returns (y (B,1,d), state)."""
    b = x.shape[0]
    w, split = _slstm_weights(params, cfg)
    st = _slstm_step(w, _slstm_gates(w, x, split)[:, 0], state)
    out = _slstm_out(w, x, st["h"].reshape(b, 1, -1), cfg, split)
    return out, _write(state, st)
