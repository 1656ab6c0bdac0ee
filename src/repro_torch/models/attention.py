"""Attention mixers: GQA self-attention (full / sliding-window / local) and
cross-attention (``xattn``, the VLM path: the text's queries against k and
v projected from the vision input, non-causal, no rotary), with
full-sequence, chunked (memory-bounded online-softmax) and single-token
decode paths.

Shape conventions:
  x          (B, S, d)
  q          (B, S, H, hd)
  k, v       (B, S, K, hd)      GQA kv heads; the plain paths expand them
                                to H, the kernels read head h // (H/K)
  cache k/v  (B, Scap, K, hd)   Scap = seq capacity or sliding window

Projections follow the reference's mixed precision: the activation (bf16
on the serving path) meets the float32 weight in a float32 product, and
the result is rounded back to the activation's type.

``impl`` names the path: ``kernel`` runs the CUDA flash-attention kernel
(prefill; differentiable through the chunked plain path, as the
reference's custom VJP) and decode-attention kernel (decode) on the card,
and their plain versions for CPU tensors; ``xla`` (dense), ``xla_chunked`` and
``xla_chunked_skip`` keep the reference's names for its plain paths, here
plain PyTorch; ``auto`` picks dense up to 2048 tokens. The kernels are
causal: ``xattn`` under ``kernel`` takes the chunked plain path in prefill
(every KV chunk visited, as the reference) and the dense product against
its static vision cache in decode.

Under a model axis of M (``common.use_rules``) a layer whose query and kv
head counts both divide by M runs on this rank's H/M query heads and K/M
kv heads (``wq``/``wk``/``wv`` split on their head axis, ``wo`` on its
first), the kernels on those heads unchanged, and the output projection's
partial sums all-reduced; its decode cache holds the local kv heads only.
Otherwise it runs whole on every rank. ``xattn`` splits as ``attn`` does:
its k and v are projected from the replicated ``vision`` source onto the
rank's kv heads, and its static vision cache holds those heads.

Under context parallelism (the ``cp_fsdp_seqpar`` table's
``attn_pref="seq"``, with the residual stream sequence-parallel) a layer
keeps its queries split over the sequence instead of its heads
(``attn_apply(seq_shard=True)``): each rank attends its own tokens'
queries, at their offset, to the whole sequence's keys. Decoding (one token) stays
split over heads, as the reference's constraint falls back to heads where
the sequence does not divide.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import (Params, apply_rope, copy_to_model,
                                       gather_seq, model_mesh, model_split,
                                       operand, param, reduce_from_model,
                                       softcap)

# the self-attention kinds: causal, rotary, and the only kinds that run
# the attention kernels (``xattn`` is the fourth kind)
CAUSAL_KINDS = ("attn", "local_attn", "swa_attn")

# the reference's logical axes of each leaf (its ``attn_init``)
AXES = {"wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
        "q_norm": ("head_dim",), "k_norm": ("head_dim",)}

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def attn_init(cfg, kind, *, generator, device=None):
    """Params for one attention layer; every kind has the same leaves.
    kind: attn|local_attn|swa_attn|xattn."""
    del kind
    d, h, k_, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    kw = dict(generator=generator, device=device)
    p = dict(wq=param((d, h, hd), **kw), wk=param((d, k_, hd), **kw),
             wv=param((d, k_, hd), **kw),
             wo=param((h, hd, d), scale=1.0 / math.sqrt(h * hd), **kw))
    if cfg.use_qk_norm:
        p["q_norm"] = param((hd,), init="zeros", **kw)
        p["k_norm"] = param((hd,), init="zeros", **kw)
    return Params(**p)


def head_split(cfg) -> int:
    """How many parts the active model axis splits a layer's heads into:
    M where both head counts divide by it, else 1 (the layer runs whole)."""
    parts = model_split(cfg.num_heads)
    return parts if cfg.num_kv_heads % parts == 0 else 1


def _weights(params, cfg, kind):
    """The layer's leaves as this rank computes with them (all of them
    outside a model-parallel context), and whether its heads are split."""
    del kind
    split = head_split(cfg) > 1
    w = {n: operand(params, n, 1 if split else None)
         for n in ("wq", "wk", "wv")}
    w["wo"] = operand(params, "wo", 0 if split else None)
    if cfg.use_qk_norm:
        for n in ("q_norm", "k_norm"):
            w[n] = operand(params, n, None, local=split)
    return w, split


def _qk_norm(x, scale, eps):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(dt)


def _project_qkv(params, cfg, x, kv_src, split=False):
    """Returns q (B,S,H,hd), k, v (B,Skv,K,hd) in x's type (H and K this
    rank's heads when ``split``). ``params``: ``_weights``'s."""
    if split:
        same = kv_src is x
        x = copy_to_model(x)
        kv_src = x if same else copy_to_model(kv_src)
    xf, sf = x.float(), kv_src.float()
    q = torch.einsum("bsd,dhe->bshe", xf, params["wq"]).to(x.dtype)
    k = torch.einsum("bsd,dke->bske", sf, params["wk"]).to(x.dtype)
    v = torch.einsum("bsd,dke->bske", sf, params["wv"]).to(x.dtype)
    if cfg.use_qk_norm:
        q = _qk_norm(q, params["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def _expand_kv(k, group):
    """(B,S,K,hd) -> (B,S,K*group,hd); q head h reads kv head h // group."""
    if group == 1:
        return k
    return torch.repeat_interleave(k, group, dim=2)


def _scale(cfg):
    return (cfg.attn_scale if cfg.attn_scale is not None
            else cfg.resolved_head_dim ** -0.5)


def _out_proj(params, cfg, o, split=False):
    """o: (B,S,H,hd) -> (B,S,d); with ``split`` the heads are this rank's
    and the partial products are summed over the model group."""
    out = torch.einsum("bshe,hed->bsd", o.float(), params["wo"])
    if split:
        out = reduce_from_model(out)
    return out.to(o.dtype)


def _window(cfg, kind):
    if kind in ("local_attn", "swa_attn"):
        return cfg.sliding_window
    return 0  # 0 = unbounded (full causal)


# ---------------------------------------------------------------------------
# full-sequence attention (train / prefill)
# ---------------------------------------------------------------------------

def _attend_dense(q, k, v, q_pos, k_pos, scale, window, cap, causal):
    """Plain (quadratic-memory) attention. q/k/v: (B,S,H,hd) (kv expanded).
    As in the reference, p is rounded to q's type before the PV product."""
    s = torch.einsum("bqhe,bthe->bhqt", q.float(), k.float()) * scale
    if cap:
        s = softcap(s, cap)
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqt,bthe->bqhe", p.to(q.dtype).float(),
                        v.float()).to(q.dtype)


def _attend_chunked(q, k, v, q_pos, k_pos, scale, window, cap, causal,
                    chunk, skip, q_offset=0):
    """Memory-bounded online-softmax attention: a loop over query chunks,
    and inside it over KV chunks. With ``skip`` the inner loop visits only
    the KV chunks that can hold a live key (causal upper triangle and
    outside the window skipped); without it every chunk is visited and
    masked. ``q_offset``: the first query's index in the keys' sequence
    (an int, for the skip's bounds, which take the positions to be
    consecutive); the masks read ``q_pos`` and ``k_pos``."""
    b, sq, heads, hd = q.shape
    skv = k.shape[1]
    cq = min(chunk, sq)
    ckv = min(chunk, skv)
    if sq % cq or skv % ckv:
        raise ValueError(f"chunked attention needs the chunk to divide the "
                         f"sequence: sq={sq} skv={skv} chunk={chunk}")
    nq, nkv = sq // cq, skv // ckv
    qf, kf, vf = q.float(), k.float(), v.float()
    outs = []
    for i in range(nq):
        q_i = qf[:, i * cq:(i + 1) * cq]
        qp_i = q_pos[i * cq:(i + 1) * cq]
        m = torch.full((b, heads, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, heads, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, heads, cq, hd), dtype=torch.float32,
                          device=q.device)
        lo, hi = 0, nkv
        if skip and causal:
            first = q_offset + i * cq
            hi = min(((first + cq - 1) // ckv) + 1, nkv)
            lo = max((first - (window - 1)) // ckv, 0) if window else 0
        for j in range(lo, hi):
            kj = kf[:, j * ckv:(j + 1) * ckv]
            vj = vf[:, j * ckv:(j + 1) * ckv]
            kp = k_pos[j * ckv:(j + 1) * ckv]
            s = torch.einsum("bqhe,bthe->bhqt", q_i, kj) * scale
            if cap:
                s = softcap(s, cap)
            mask = torch.ones((cq, ckv), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kp[None, :] <= qp_i[:, None]
            if window:
                mask &= qp_i[:, None] - kp[None, :] < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqt,bthe->bhqe", p.to(q.dtype).float(), vj)
            m = m_new
        l = torch.clamp(l, min=1e-30)
        o = (acc / l[..., None]).to(q.dtype)        # (b,h,cq,hd)
        outs.append(o.transpose(1, 2))              # (b,cq,h,hd)
    return torch.cat(outs, dim=1)


class _FlashAttention(torch.autograd.Function):
    """Causal attention on the flash-attention kernel, differentiable: the
    reference's ``jax.custom_vjp`` in its ``_attend_flash_kernel``.

    Forward: the kernel (its plain version for CPU tensors). q (B,Sq,H,hd)
    and k, v (B,Sk,K,hd) go in as (B,H,S,hd) views, unexpanded: the kernel
    reads kv head h // (H/K) itself; query i sits at position ``q_offset +
    i`` of the keys (0 and Sq = Sk but under context parallelism).
    Backward: autograd through the chunked plain path (``_attend_chunked``)
    recomputed from the saved q, k, v, with fixed trip counts
    (``skip=False``, as the reference) and positions ``q_offset +
    arange(Sq)`` against ``arange(Sk)``; K/V are expanded inside the
    recomputation, so dk and dv sum back to the K heads."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window, cap, chunk, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (scale, window, cap, chunk, q_offset)
        o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), scale=scale, causal=True,
                                 window=window, softcap=cap or 0.0,
                                 q_offset=q_offset)
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        scale, window, cap, chunk, q_offset = ctx.opts
        q, k, v = ctx.saved_tensors
        group = q.shape[2] // k.shape[2]
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        with torch.enable_grad():
            q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
            o = _attend_chunked(q, _expand_kv(k, group), _expand_kv(v, group),
                                q_pos, k_pos, scale, window, cap, True, chunk,
                                skip=False)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None, None, None, None, None)


def _attend_flash_kernel(q, k, v, *, scale, window, cap, chunk, q_offset=0):
    """Causal attention on the flash-attention kernel, with the backward of
    ``_FlashAttention``. q (B,Sq,H,hd), k, v (B,Sk,K,hd) -> (B,Sq,H,hd),
    query i at position ``q_offset + i``."""
    return _FlashAttention.apply(q, k, v, scale, window, cap, chunk,
                                 q_offset)


def attn_apply(params, x, *, cfg, kind, positions, kv_src=None, impl=None,
               seq_shard=False):
    """Full-sequence attention (training / prefill).

    positions: (S,) int token positions. kv_src: (B,Sv,d), the source of
    an ``xattn`` layer's k and v (default ``x``). Returns (out (B,S,d),
    (k, v)) — k, v returned so that prefill can seed caches.

    ``seq_shard`` (context parallelism, ``cp_fsdp_seqpar``: the
    reference's ``attn_pref="seq"``): ``x`` is this rank's shard (B,S/M,d)
    of the S tokens, rank i's at offset i·S/M, and so is the output. The
    layer then computes with its whole weights (gathered; their gradients
    summed over the model group) on its own rows: q of its tokens, every
    head; k and v of its tokens gathered over the model group into the
    whole sequence (an ``xattn`` layer's from the replicated vision
    source); attention of its queries against every key; the output
    projection of its rows, which needs no sum. The returned (k, v) are
    this rank's kv heads, as the decode cache holds them.

    The masks read ``positions``; the flash-attention kernel and the
    chunked path's skip read the queries' offset in the keys' sequence
    instead, so they take ``positions`` to be consecutive
    (``positions[i] == positions[0] + i``), as training and prefill give.
    """
    causal = kind in CAUSAL_KINDS
    off = 0
    if seq_shard:
        mesh = model_mesh()
        off = mesh.model_index * (positions.shape[0] // mesh.model)
        w = {n: operand(params, n, None, local=True)
             for n in ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
             if n in params._parameters}
        split = False
        src = x if causal else copy_to_model(kv_src)
    else:
        w, split = _weights(params, cfg, kind)
        src = x if kv_src is None else kv_src
    q_pos = positions[off:off + x.shape[1]]
    q, k, v = _project_qkv(w, cfg, x, src, split)
    if cfg.pos_emb == "rope" and causal:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)
    if seq_shard and causal:
        k = copy_to_model(gather_seq(k))
        v = copy_to_model(gather_seq(v))
    window = _window(cfg, kind)
    kv_pos = (positions if causal
              else torch.arange(src.shape[1], device=x.device))
    impl = impl or cfg.attn_impl
    if impl == "auto":
        impl = "xla" if positions.shape[0] <= 2048 else "xla_chunked_skip"
    group = q.shape[2] // k.shape[2]
    if impl == "kernel" and causal:
        o = _attend_flash_kernel(q, k, v, scale=_scale(cfg), window=window,
                                 cap=cfg.attn_logit_softcap,
                                 chunk=cfg.attn_chunk, q_offset=off)
    elif impl == "xla":
        o = _attend_dense(q, _expand_kv(k, group), _expand_kv(v, group),
                          q_pos, kv_pos, _scale(cfg), window,
                          cfg.attn_logit_softcap, causal)
    elif impl in ("xla_chunked", "xla_chunked_skip", "kernel"):
        # the non-causal kernel impl (xattn) falls back to this path
        o = _attend_chunked(q, _expand_kv(k, group), _expand_kv(v, group),
                            q_pos, kv_pos, _scale(cfg), window,
                            cfg.attn_logit_softcap, causal, cfg.attn_chunk,
                            skip=impl == "xla_chunked_skip", q_offset=off)
    else:
        raise ValueError(f"unknown attn impl {impl}")
    out = _out_proj(w, cfg, o, split)
    parts = head_split(cfg)
    if seq_shard and parts > 1:
        n = k.shape[2] // parts
        k = k[:, :, mesh.model_index * n:(mesh.model_index + 1) * n]
        v = v[:, :, mesh.model_index * n:(mesh.model_index + 1) * n]
    return out, (k, v)


# ---------------------------------------------------------------------------
# decode (single token, KV cache)
# ---------------------------------------------------------------------------

def attn_cache_init(cfg, kind, batch, seq_len, dtype, device=None):
    """Zero cache for one attention layer. Full attention: capacity =
    seq_len. Windowed: a ring buffer of the window's size. xattn: the
    static vision k/v, ``cfg.vision_seq`` slots. Under a model axis that
    splits the layer's heads, this rank's kv heads only."""
    k_, hd = cfg.num_kv_heads // head_split(cfg), cfg.resolved_head_dim
    window = _window(cfg, kind)
    if kind == "xattn":
        cap = cfg.vision_seq
    else:
        cap = min(seq_len, window) if window else seq_len
    return {
        "k": torch.zeros((batch, cap, k_, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cap, k_, hd), dtype=dtype, device=device),
    }


def attn_decode(params, x, cache, *, cfg, kind, pos, impl=None):
    """One-token decode. x: (B,1,d); pos: a scalar int (lockstep decode,
    every row at the same position) or a (B,) int32 tensor (continuous
    batching: rope, cache writes and validity become per-row).

    The new token's k and v are written into ``cache`` in place (slot
    ``pos``, or ``pos % cap`` in a ring buffer) and the same dict is
    returned. ``impl="kernel"`` runs the decode-attention
    kernel against the cache as it lies (its plain version for CPU
    tensors); anything else the grouped dense product. ``xattn`` attends
    densely to its static vision cache, whatever the impl, and writes
    nothing.
    Returns (out (B,1,d), cache).
    """
    group = cfg.num_heads // cfg.num_kv_heads
    params, split = _weights(params, cfg, kind)
    if kind == "xattn":
        q, _, _ = _project_qkv(params, cfg, x, x, split)
        k, v = cache["k"], cache["v"]
        kv_pos = torch.arange(k.shape[1], device=x.device)
        o = _attend_dense(q, _expand_kv(k, group), _expand_kv(v, group),
                          None, kv_pos, _scale(cfg), 0,
                          cfg.attn_logit_softcap, False)
        return _out_proj(params, cfg, o, split), cache
    q, k_new, v_new = _project_qkv(params, cfg, x, x, split)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    vec = pos.dim() == 1                    # per-row positions
    if cfg.pos_emb == "rope":
        pos_arr = pos[:, None] if vec else pos[None]
        q = apply_rope(q, pos_arr, cfg.rope_theta)
        k_new = apply_rope(k_new, pos_arr, cfg.rope_theta)

    k, v = cache["k"], cache["v"]
    cap = k.shape[1]
    window = _window(cfg, kind)
    slot = torch.remainder(pos, cap) if window else pos
    if vec:
        rows = torch.arange(x.shape[0], device=x.device)
        k[rows, slot] = k_new[:, 0].to(k.dtype)
        v[rows, slot] = v_new[:, 0].to(v.dtype)
    else:
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)

    # position held by each cache slot (ring-buffer aware); with per-row
    # pos every quantity gains a leading batch axis
    idx = torch.arange(cap, dtype=torch.int32, device=x.device)
    rpos = pos[:, None] if vec else pos
    if window:
        slot_pos = rpos - torch.remainder(rpos - idx, cap)
    else:
        slot_pos = idx.expand(x.shape[0], cap) if vec else idx

    impl = impl or cfg.attn_impl
    if impl == "kernel":
        o = kops.decode_attention(
            q[:, 0], k.transpose(1, 2), v.transpose(1, 2), slot_pos, pos,
            scale=_scale(cfg), softcap=cfg.attn_logit_softcap or 0.0,
            window=window)
        return _out_proj(params, cfg, o[:, None], split), cache

    # grouped GQA product directly against the compact (B,S,K,hd) cache:
    # the small q is reshaped to (K, G), the cache keeps its K axis
    valid = (slot_pos >= 0) & (slot_pos <= rpos)
    if window:
        valid &= rpos - slot_pos < window
    b, hd = q.shape[0], q.shape[-1]
    qg = q.reshape(b, 1, k.shape[2], group, hd)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg.float(), k.float()) * _scale(cfg)
    if cfg.attn_logit_softcap:
        s = softcap(s, cfg.attn_logit_softcap)
    vmask = (valid[:, None, None, None, :] if vec
             else valid[None, None, None, None, :])
    s = torch.where(vmask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkh->bqkgh", p.to(q.dtype).float(),
                     v.float()).to(q.dtype)
    o = o.reshape(b, 1, q.shape[2], hd)
    return _out_proj(params, cfg, o, split), cache


def attn_prefill_cache(cfg, kind, kv, seq_len, dtype):
    """Build a decode cache from prefill KV (k, v each (B,S,K,hd))."""
    k, v = kv
    b = k.shape[0]
    cache = attn_cache_init(cfg, kind, b, seq_len, dtype, device=k.device)
    window = _window(cfg, kind)
    cap = cache["k"].shape[1]
    s = k.shape[1]
    if window and s > cap:
        # keep the last `cap` positions, ring-aligned: slot = pos % cap
        roll = (s - cap) % cap
        return {"k": torch.roll(k[:, s - cap:], roll, dims=1).to(dtype),
                "v": torch.roll(v[:, s - cap:], roll, dims=1).to(dtype)}
    cache["k"][:, :s] = k.to(dtype)
    cache["v"][:, :s] = v.to(dtype)
    return cache
