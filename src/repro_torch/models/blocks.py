"""Super-block composition: each architecture is ``num_groups`` repetitions
of ``cfg.block_pattern`` (a tuple of (mixer, ffn) layer specs). One
super-block's params form one ``Params`` node; ``model.py`` keeps one per
group, and one more for the zamba-style shared block, whose pattern it
passes as ``pattern``.

Residual wiring: pre-norm (gemma2 adds sandwich post-norms). Mixers: the
attention kinds ``attn``, ``local_attn``, ``swa_attn`` and ``xattn``
(cross-attention to the ``vision`` input), ``mamba`` (Mamba2), ``mlstm``
and ``slstm`` (xLSTM); FFNs: ``swiglu``, ``geglu``, ``gelu``, ``moe`` and
``none``. A layer's decode cache is {"k", "v"} for attention (the static
vision k/v for ``xattn``), {"conv", "ssm"} for Mamba2, {"C", "m", "n"}
for mLSTM and {"c", "h", "m", "n"} for sLSTM, the recurrent states in
float32. MoE aux losses are returned as a summed (load_balance, z_loss,
dropped) triple, as in the reference.

Sequence parallel (``seq_split``: the rules map ``act_seq`` to "model"
and the model axis divides S): the residual ``x`` is this rank's
(B, S/M, d) shard. Each sublayer normalises the shard (its scale's
gradient summed over the model group), gathers the sequence where the
reference puts ``gather_seq`` (after the pre-norm), runs the mixer or
FFN on the whole sequence as under Megatron, and keeps the rank's shard
of the output (``scatter_seq``) for the residual add. Under context
parallelism (``cp_fsdp_seqpar``'s ``attn_pref="seq"``) an attention
sublayer skips both: it attends the shard's queries to the whole
sequence's keys (``attention.attn_apply(seq_shard=True)``) and returns
the shard's output, so its norms act on the shard alone.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, mamba, mlp, moe, xlstm
from repro_torch.models.common import (Params, gather_seq, make_norm,
                                       remat, remat_active, rule,
                                       scatter_seq, seq_local)

ATTN_KINDS = attention.CAUSAL_KINDS + ("xattn",)
# the recurrent mixers' (init, apply, decode, cache_init(cfg, batch, dtype,
# device)); the xLSTM states are float32 whatever the activation's type
_RECURRENT = {
    "mamba": (mamba.mamba_init, mamba.mamba_apply, mamba.mamba_decode,
              mamba.mamba_cache_init),
    "mlstm": (xlstm.mlstm_init, xlstm.mlstm_apply, xlstm.mlstm_decode,
              lambda cfg, batch, dtype, device: xlstm.mlstm_state_init(
                  cfg, batch, device=device)),
    "slstm": (xlstm.slstm_init, xlstm.slstm_apply, xlstm.slstm_decode,
              lambda cfg, batch, dtype, device: xlstm.slstm_state_init(
                  cfg, batch, device=device))}


def _mixer_init(cfg, kind, **kw):
    if kind in ATTN_KINDS:
        return attention.attn_init(cfg, kind, **kw)
    if kind in _RECURRENT:
        return _RECURRENT[kind][0](cfg, **kw)
    raise ValueError(f"unknown mixer kind {kind!r}")


def block_init(cfg, *, generator, device=None, pattern=None):
    """Params for one super-block."""
    pattern = pattern if pattern is not None else cfg.block_pattern
    norm_init, _ = make_norm(cfg)
    kw = dict(generator=generator, device=device)
    layers = {}
    for idx, (mixer, ffn) in enumerate(pattern):
        layer = {"pre_norm": norm_init(cfg.d_model, device=device),
                 "mixer": _mixer_init(cfg, mixer, **kw)}
        if cfg.sandwich_norm:
            layer["post_norm"] = norm_init(cfg.d_model, device=device)
        if ffn != "none":
            layer["ffn_pre_norm"] = norm_init(cfg.d_model, device=device)
            layer["ffn"] = (moe.moe_init(cfg, **kw) if ffn == "moe"
                            else mlp.mlp_init(cfg, ffn, **kw))
            if cfg.sandwich_norm:
                layer["ffn_post_norm"] = norm_init(cfg.d_model,
                                                   device=device)
        layers[f"l{idx}"] = Params(**layer)
    return Params(**layers)


def zero_aux(device=None):
    """(load_balance, z_loss, dropped_frac) of a model without MoE."""
    return tuple(torch.zeros((), dtype=torch.float32, device=device)
                 for _ in range(3))


def _add_aux(a, b):
    """The sum of two aux triples; None stands for a zero one (no MoE
    layer so far), so dense layers launch nothing for it."""
    if a is None or b is None:
        return b if a is None else a
    return tuple(x + y for x, y in zip(a, b))


def _pre_norm(norm_fn, node, x, seq_split, gather=True):
    """The pre-norm of a sublayer's input; under ``seq_split`` over the
    rank's sequence shard, then gathered (the reference's
    ``gather_seq``) unless the sublayer takes the shard (``gather``
    False)."""
    if not seq_split:
        return norm_fn(node, x)
    with seq_local():
        h = norm_fn(node, x)
    return gather_seq(h) if gather else h


def _apply_ffn(layer, x, cfg, ffn, norm_fn, seq_split=False):
    """Returns (x + ffn(x), aux); aux is None for a dense FFN."""
    aux = None
    h = _pre_norm(norm_fn, layer["ffn_pre_norm"], x, seq_split)
    if ffn == "moe":
        h, moe_aux = moe.moe_apply(layer["ffn"], h, cfg)
        aux = tuple(moe_aux)
    else:
        h = mlp.mlp_apply(layer["ffn"], h, ffn)
    if cfg.sandwich_norm:
        h = norm_fn(layer["ffn_post_norm"], h)
    if seq_split:
        h = scatter_seq(h)
    return x + h, aux


def block_apply(params, x, *, cfg, positions, pattern=None, vision=None,
                impl=None, build_cache=False, seq_len=None, dtype=None,
                seq_split=False):
    """Full-sequence super-block. Returns (x, aux, cache|None): aux the
    layers' summed MoE losses (None without an MoE layer), and with
    ``build_cache`` (prefill) the cache holds this block's decode caches.
    ``vision`` (B, Sv, d) is the source of the ``xattn`` layers' k and v.
    ``impl`` is the attention impl; Mamba2 reads ``cfg.ssd_impl``.
    ``seq_split``: ``x`` is this rank's sequence shard (module docstring).

    Nested remat, as the reference: with ``cfg.remat`` and autograd
    recording, each LAYER of a multi-layer super-block (Zamba2's six
    Mamba2 layers, gemma2's pairs) is its own checkpoint region, so the
    block's backward holds one layer's intermediates at a time. Its
    kernels then run again in the backward pass. The region returns the
    layer's aux with its output, so the router losses keep their
    gradient."""
    pattern = pattern if pattern is not None else cfg.block_pattern
    _, norm_fn = make_norm(cfg)

    # context parallelism: attention takes the sequence shard
    cp = seq_split and rule("attn_pref") == "seq"

    def layer_fn(layer, x, mixer, ffn):
        aux = None
        shard = cp and mixer not in _RECURRENT
        h = _pre_norm(norm_fn, layer["pre_norm"], x, seq_split,
                      gather=not shard)
        lcache = None
        if mixer in _RECURRENT:
            h, lcache = _RECURRENT[mixer][1](layer["mixer"], h, cfg,
                                             return_state=build_cache)
        else:
            h, kv = attention.attn_apply(
                layer["mixer"], h, cfg=cfg, kind=mixer, positions=positions,
                kv_src=vision if mixer == "xattn" else None, impl=impl,
                seq_shard=shard)
            if build_cache:
                lcache = attention.attn_prefill_cache(cfg, mixer, kv,
                                                      seq_len, dtype)
        if cfg.sandwich_norm:
            if shard:
                with seq_local():
                    h = norm_fn(layer["post_norm"], h)
            else:
                h = norm_fn(layer["post_norm"], h)
        if seq_split and not shard:
            h = scatter_seq(h)
        x = x + h
        if ffn != "none":
            x, aux = _apply_ffn(layer, x, cfg, ffn, norm_fn, seq_split)
        return x, aux, lcache

    nested = len(pattern) > 1 and remat_active(cfg, build_cache)
    aux = None
    cache = {} if build_cache else None
    for idx, (mixer, ffn) in enumerate(pattern):
        layer = params[f"l{idx}"]
        if nested:
            x, layer_aux, _ = remat(layer_fn, layer, x, mixer, ffn)
        else:
            x, layer_aux, lcache = layer_fn(layer, x, mixer, ffn)
            if build_cache:
                cache[f"l{idx}"] = lcache
        aux = _add_aux(aux, layer_aux)
    return x, aux, cache


def block_decode(params, x, cache, *, cfg, pos, pattern=None, impl=None):
    """One-token decode through a super-block; each layer's cache is
    written in place (an ``xattn`` layer's vision k/v only read). Returns
    (x, cache). An MoE layer routes every row, idle slots included, and
    its aux is dropped, as in the reference."""
    pattern = pattern if pattern is not None else cfg.block_pattern
    _, norm_fn = make_norm(cfg)
    for idx, (mixer, ffn) in enumerate(pattern):
        layer = params[f"l{idx}"]
        h = norm_fn(layer["pre_norm"], x)
        if mixer in _RECURRENT:
            h, _ = _RECURRENT[mixer][2](layer["mixer"], h, cache[f"l{idx}"],
                                        cfg)
        else:
            h, _ = attention.attn_decode(layer["mixer"], h, cache[f"l{idx}"],
                                         cfg=cfg, kind=mixer, pos=pos,
                                         impl=impl)
        if cfg.sandwich_norm:
            h = norm_fn(layer["post_norm"], h)
        x = x + h
        if ffn != "none":
            x, _ = _apply_ffn(layer, x, cfg, ffn, norm_fn)
    return x, cache


def block_cache_init(cfg, batch, seq_len, dtype, device=None, pattern=None):
    """Zero decode cache for one super-block: attention k/v and Mamba2's
    conv window in ``dtype``; the recurrent states in float32."""
    pattern = pattern if pattern is not None else cfg.block_pattern
    cache = {}
    for idx, (mixer, _) in enumerate(pattern):
        if mixer in _RECURRENT:
            c = _RECURRENT[mixer][3](cfg, batch, dtype, device=device)
        else:
            c = attention.attn_cache_init(cfg, mixer, batch, seq_len, dtype,
                                          device=device)
        cache[f"l{idx}"] = c
    return cache
