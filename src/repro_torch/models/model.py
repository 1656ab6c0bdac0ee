"""Top-level decoder: embed -> ``num_groups`` super-blocks (each followed,
in the Zamba2 hybrids, by the shared attention block) -> final norm ->
heads (LM logits over the vocabulary = policy logits; a scalar baseline
for IMPALA).

``init`` returns the parameter tree as a :class:`Params` module: the
reference stacks every block leaf on a leading ``num_groups`` axis for
``lax.scan``; here ``params["blocks"]`` is a list of one node per group
(``convert.py`` unstacks and restacks). With ``shared_attn_every`` the
zamba-style shared block ``params["shared"]`` (pattern ``SHARED_PATTERN``,
one attention layer and one SwiGLU FFN) runs after every group with the
same weights. The apply functions take that tree.

The decode cache mirrors the reference's: ``{"block": {"l<i>": leaves}}``,
plus ``"shared": {"l0": {"k", "v"}}`` for the hybrids, every leaf stacked
on a leading num_groups axis. An attention layer's leaves are k and v
(G, B, cap, K, hd) (an ``xattn`` layer's: the vision k/v, cap
``vision_seq``); a Mamba2 layer's are conv (G, B, W-1, C), the last
inputs of its depthwise convolution, and ssm (G, B, H, P, N) in float32;
an mLSTM layer's C, m, n and an sLSTM layer's c, h, m, n, in float32.
``decode_step`` writes each layer's new entries into it in place, group by
group, which is what the reference's ``unroll=True`` serve path makes XLA
do with the donated cache buffer; no second copy of the cache is ever
made.

Model parallel (``--mesh-model``): ``param_specs`` decides, with the
reference's ``spec_for`` over ``logical_axes`` (its ``param(..., axes)``
declarations, block leaves with the stacked ``layers`` axis first), which
dimension of each leaf a rank holds, and ``shard_model`` cuts a whole
tree down to a rank's slices. Under ``common.use_rules`` the embedding is
vocab-parallel where the rules split ``vocab``: each rank looks up the
tokens in its rows (the others' rows give zero) and the sum over the
model group is the embedding; the tied or untied head then gives each
rank its vocabulary slice of the logits, which the losses reduce over the
group (``core/losses.py``) and ``logits_from_hidden`` gathers. Where the
rules drop ``vocab`` (an odd vocabulary), every rank computes the whole
logits. Every mixer takes the model axis.

Under the other rules tables: FSDP leaves (``embed`` over the data axes)
are held split on two dimensions and gathered over the data group at use
(``common.operand``), and with sequence parallel (``act_seq`` over
"model") the residual stream leaves the embedding as this rank's
sequence shard, stays so between sublayers (``blocks.py``), and is
gathered again before the final norm, so the head and the losses see
the whole sequence.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.models import attention, blocks, mamba, mlp, moe, xlstm
from repro_torch.models.common import (Params, copy_to_model, dtype_of,
                                       gather_model_slices, gather_seq,
                                       make_norm, model_mesh, model_split,
                                       operand, param, reduce_from_model,
                                       remat, remat_active, scatter_seq,
                                       seq_parallel, shard_params,
                                       sinusoidal_pos_emb, softcap, tree_map)

SHARED_PATTERN = (("attn", "swiglu"),)  # zamba-style shared global block


def init(cfg, *, seed=0, device=None):
    """A freshly initialised parameter tree for ``cfg`` on ``device``,
    drawn from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    norm_init, _ = make_norm(cfg)
    p = {
        # 1/sqrt(d): keeps initial logits O(1) for both tied and untied
        # heads -> near-uniform initial policy (entropy ~ log V)
        "embed": param((cfg.vocab_size, cfg.d_model),
                       scale=cfg.d_model ** -0.5, **kw),
        "blocks": nn.ModuleList([blocks.block_init(cfg, **kw)
                                 for _ in range(cfg.num_groups)]),
        "final_norm": norm_init(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = param((cfg.d_model, cfg.vocab_size), **kw)
    if cfg.shared_attn_every:
        p["shared"] = blocks.block_init(cfg, pattern=SHARED_PATTERN, **kw)
    if cfg.baseline_head:
        p["baseline"] = param((cfg.d_model,), scale=cfg.d_model ** -0.5,
                              **kw)
    return Params(**p)


# ---------------------------------------------------------------------------
# model parallel: the logical-axes table and the slicer
# ---------------------------------------------------------------------------

_NORMS = ("pre_norm", "post_norm", "ffn_pre_norm", "ffn_post_norm")
_TOP_AXES = {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
             "baseline": ("embed",)}


def _mixer_axes(kind):
    if kind in blocks.ATTN_KINDS:
        return attention.AXES
    return {"mamba": mamba.AXES, "mlstm": xlstm.MLSTM_AXES,
            "slstm": xlstm.SLSTM_AXES}[kind]


def logical_axes(params, cfg):
    """State-dict name -> the reference's logical axes of that leaf (a
    block leaf's without the stacked ``layers`` axis)."""
    out = {}
    for name, _ in params.named_parameters():
        parts = name.split(".")
        if parts[0] in _TOP_AXES:
            out[name] = _TOP_AXES[parts[0]]
            continue
        if parts[0] == "final_norm":
            out[name] = ("embed",)
            continue
        pattern = SHARED_PATTERN if parts[0] == "shared" \
            else cfg.block_pattern
        layer, part, leaf = parts[-3:]
        mixer, ffn = pattern[int(layer[1:])]
        if part in _NORMS:
            out[name] = ("embed",)
        elif part == "mixer":
            out[name] = _mixer_axes(mixer)[leaf]
        else:
            out[name] = (moe.AXES if ffn == "moe" else mlp.AXES)[leaf]
    return out


def stacked_axes(params, cfg, shapes):
    """(state-dict name -> logical axes, -> shape) of the reference's
    leaves: a block leaf's with its stacked ``layers`` axis first,
    ``num_groups`` long. ``shapes``: the port's whole leaf shapes."""
    axes, out = logical_axes(params, cfg), {}
    for name, shape in shapes.items():
        out[name] = tuple(shape)
        if name.startswith("blocks."):
            axes[name] = ("layers",) + tuple(axes[name])
            out[name] = (cfg.num_groups,) + out[name]
    return axes, out


def param_specs(params, cfg, mesh, rules):
    """State-dict name -> (the reference's partition spec of its leaf,
    the dimension of the port's leaf a rank holds a slice of, or None) for
    a WHOLE tree. A block leaf's spec is that of the reference's stacked
    leaf (``layers`` first, ``num_groups`` long), as its checkpoints
    record it; a split of that ``layers`` axis is ``LAYERS`` (FSDP's
    norm scales: ``embed`` takes the data axes, and ``fallback_model``
    the stacked axis), and ``shard_model`` gives each group's leaf to one
    model rank whole."""
    axes, shapes = stacked_axes(
        params, cfg, {n: p.shape for n, p in params.named_parameters()})
    return {name: (spec, _port_dim(name, spec, "model"))
            for name, spec in sharding.param_shardings(
                axes, mesh, rules, shapes).items()}


def check_model_parallel(cfg, model: int) -> None:
    """Refuse a model axis the layers cannot take: every mixer and FFN of
    the registry takes one of any size (a head count it does not divide
    runs whole on every rank), so only a size below 1 is refused."""
    if model < 1:
        raise ValueError(f"--mesh-model {model} for {cfg.name}: the model "
                         "axis must be at least 1")


# a block leaf split over its stacked ``layers`` axis: each group's leaf
# lies whole on one rank of the axis
LAYERS = "layers"


def _port_dim(name, spec, axis):
    """The dimension of the port's leaf ``name`` that ``spec`` (the
    reference's, a block leaf's with its stacked ``layers`` axis first)
    splits over ``axis``, ``LAYERS`` for that stacked axis, or None."""
    dim = sharding.axis_dim(spec, axis)
    if dim is None or not name.startswith("blocks."):
        return dim
    return LAYERS if dim == 0 else dim - 1


def shard_model(params, cfg, mesh, rules):
    """Cut the whole tree ``params`` (every rank builds the same one from
    the same seed) down to ``mesh``'s slice, in place: each leaf's model
    slice and, where the rules split it over the data axes (FSDP), its
    data slice too. Records each leaf's spec, model dimension and whole
    shape on it (``params.model_layout``: the sharded checkpoint reads
    it; the spec names the data dimension as well). Returns ``params``."""
    check_model_parallel(cfg, mesh.model)
    specs = param_specs(params, cfg, mesh, rules)
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    data = {n: _port_dim(n, spec, "data") for n, (spec, _) in specs.items()}
    if LAYERS in data.values():
        raise NotImplementedError(
            "not ported yet: a stacked layers axis split over the data "
            "axes (no rules table maps 'layers')")
    per = cfg.num_groups // mesh.model
    shard_params(params, {n: d for n, (_, d) in specs.items()
                          if d not in (None, LAYERS)}, mesh,
                 {n: d for n, d in data.items() if d is not None},
                 {n: int(n.split(".")[1]) // per
                  for n, (_, d) in specs.items() if d == LAYERS})
    params.__dict__["model_layout"] = {
        n: (spec, dim, shapes[n]) for n, (spec, dim) in specs.items()}
    return params


def zero_slices(params, cfg, mesh, rules):
    """Per parameter (``named_parameters`` order), this data rank's
    ``optim.ZeroSlice`` of its optimizer state, the reference's
    ``zero1_shardings`` decision on the stacked leaf, or None (an FSDP
    leaf, already split over the data axes; no divisible dimension; a
    data axis of 1). A block leaf whose state the reference splits on its
    ``layers`` axis keeps its whole state on the data rank that holds its
    group and none elsewhere. ``params``: this rank's tree, cut by
    ``shard_model`` (its ``model_layout`` gives the whole shapes)."""
    from repro_torch.optim.optimizers import ZeroSlice
    layout = params.model_layout
    axes, shapes = stacked_axes(params, cfg,
                                {n: v[2] for n, v in layout.items()})
    state = sharding.zero1_shardings(axes, mesh, rules, shapes)
    out = []
    for name, leaf in params.named_parameters():
        dim = sharding.axis_dim(state[name], "data")
        if mesh.data == 1 or dim is None \
                or sharding.axis_dim(layout[name][0], "data") is not None:
            out.append(None)
            continue
        if name.startswith("blocks."):
            if dim == 0:
                mine = int(name.split(".")[1]) \
                    // (cfg.num_groups // mesh.data) == mesh.data_index
                out.append(ZeroSlice(0, 0, leaf.shape[0] if mine else 0))
                continue
            dim -= 1
        n = leaf.shape[dim] // mesh.data
        out.append(ZeroSlice(dim, mesh.data_index * n, n))
    return out


def split_dims(params):
    """State-dict name -> the dimension of the leaf this rank holds a
    model slice of (None: whole), from the tree's nodes."""
    return _held_dims(params, "shard_dims")


def data_dims(params):
    """State-dict name -> the dimension of the leaf this rank holds a
    data slice of (FSDP; None: whole over the data group)."""
    return _held_dims(params, "data_dims")


def owned(params):
    """State-dict name -> whether the leaf lies whole on one model rank
    and empty on the others (a ``LAYERS`` split)."""
    return {n: v is not None for n, v in _held_dims(params, "owners").items()}


def _held_dims(params, attr):
    out = {}
    for path, node in params.named_modules():
        for name in node._parameters:
            full = f"{path}.{name}" if path else name
            out[full] = getattr(node, attr).get(name)
    return out


def vocab_start(cfg):
    """The first vocabulary index of this rank's slice of the logits, or
    None when every rank computes the whole vocabulary."""
    parts = model_split(cfg.vocab_size)
    if parts == 1:
        return None
    return model_mesh().model_index * (cfg.vocab_size // parts)


def _embed(params, cfg, tokens, positions):
    start = vocab_start(cfg)
    if start is None:
        x = operand(params, "embed")[tokens].to(dtype_of(cfg))
    else:
        table = operand(params, "embed", 0)               # (V/M, d)
        local = tokens - start
        inside = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)] * inside[..., None]
        x = reduce_from_model(rows).to(dtype_of(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_pos_emb(positions, cfg.d_model).to(x.dtype)
    return x


def unembed_matrix(params, cfg):
    """(d, V) — this rank's (d, V/M) columns where ``vocab_start`` is not
    None."""
    split = vocab_start(cfg) is not None
    if cfg.tie_embeddings:
        return operand(params, "embed", 0 if split else None).T
    return operand(params, "unembed", 1 if split else None)


def logits_from_hidden(params, cfg, h):
    """float32 logits. As in the reference, the unembedding is first
    rounded to the hidden's type (bf16 on the serving path), then
    multiplied in float32. With vocab-parallel logits every rank gets the
    whole vocabulary, gathered over the model group without a gradient
    (the learner's losses take the slices: ``core/losses.py``)."""
    w = unembed_matrix(params, cfg)
    split = vocab_start(cfg) is not None
    logits = (copy_to_model(h) if split else h).float() \
        @ w.to(h.dtype).float()
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return gather_model_slices(logits, -1) if split else logits


def baseline_from_hidden(params, cfg, h):
    if not cfg.baseline_head:
        return None
    return h.float() @ operand(params, "baseline").float()


def forward(params, tokens, *, cfg, vision=None, impl=None,
            build_cache=False, cache_seq_len=None):
    """Forward over a full sequence. tokens: (B, S) int; vision: (B, Sv, d)
    patch embeddings (the VLM stub), read by the ``xattn`` layers.

    Returns (hidden (B,S,d), aux, cache|None): aux = (load_balance,
    z_loss, dropped_frac) summed over all MoE layers (zeros without MoE),
    and with ``build_cache`` the decode cache of every layer, capacity
    ``cache_seq_len``.

    With ``cfg.remat`` and autograd recording, each group (its super-block
    and the shared block after it) is one checkpoint region, as the
    reference's ``jax.checkpoint`` of its scan body: the values are the
    same, the group's intermediates are recomputed in the backward pass,
    and so are its kernel launches. The region returns the group's aux
    with its output, so the router losses keep their gradient.
    """
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    x = _embed(params, cfg, tokens, positions)
    split = seq_parallel(s)
    if split:
        x = scatter_seq(x)
    kw = dict(cfg=cfg, positions=positions, impl=impl,
              build_cache=build_cache, seq_len=cache_seq_len, dtype=x.dtype,
              seq_split=split)

    def body(block_params, x):
        x, aux, cache = blocks.block_apply(block_params, x, vision=vision,
                                           **kw)
        cache = {"block": cache}
        if cfg.shared_attn_every:
            x, saux, cache["shared"] = blocks.block_apply(
                params["shared"], x, pattern=SHARED_PATTERN, **kw)
            aux = blocks._add_aux(aux, saux)
        return x, aux, cache

    checkpointed = remat_active(cfg, build_cache)
    aux, caches = None, []
    for block_params in params["blocks"]:
        if checkpointed:
            x, baux, _ = remat(body, block_params, x)
        else:
            x, baux, cache = body(block_params, x)
            caches.append(cache)
        aux = blocks._add_aux(aux, baux)
    if split:
        x = gather_seq(x)
    _, norm_fn = make_norm(cfg)
    x = norm_fn(params["final_norm"], x)
    if aux is None:
        aux = blocks.zero_aux(x.device)
    if not build_cache:
        return x, aux, None
    return x, aux, tree_map(lambda *leaves: torch.stack(leaves), *caches)


def cache_init(cfg, batch, seq_len, device=None):
    """Zero decode cache matching ``prefill``'s: leaves (G, B, ...)."""
    dtype = dtype_of(cfg)
    one = {"block": blocks.block_cache_init(cfg, batch, seq_len, dtype,
                                            device=device)}
    if cfg.shared_attn_every:
        one["shared"] = blocks.block_cache_init(
            cfg, batch, seq_len, dtype, device=device, pattern=SHARED_PATTERN)
    return tree_map(lambda a: torch.zeros((cfg.num_groups,) + a.shape,
                                          dtype=a.dtype, device=a.device),
                    one)


def prefill(params, tokens, *, cfg, vision=None, impl=None, cache_seq_len):
    """Forward + build decode caches (an ``xattn`` layer's holds the vision
    k/v). Returns (hidden (B,S,d), aux, cache)."""
    return forward(params, tokens, cfg=cfg, vision=vision, impl=impl,
                   build_cache=True, cache_seq_len=cache_seq_len)


def decode_step(params, tokens, cache, pos, *, cfg, impl=None):
    """One-token decode. tokens: (B,1) int; pos: a scalar int (the position
    of this token; lockstep decode) or a (B,) int32 tensor (per-slot
    positions: the continuous-batching serve path). ``cache`` is written in
    place, layer by layer. Returns (hidden (B,1,d), cache)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    x = _embed(params, cfg, tokens, pos[:, None] if pos.dim() else pos[None])
    for g, block_params in enumerate(params["blocks"]):
        group_cache = tree_map(lambda a: a[g], cache)
        x, _ = blocks.block_decode(block_params, x, group_cache["block"],
                                   cfg=cfg, pos=pos, impl=impl)
        if cfg.shared_attn_every:
            x, _ = blocks.block_decode(params["shared"], x,
                                       group_cache["shared"], cfg=cfg,
                                       pos=pos, pattern=SHARED_PATTERN,
                                       impl=impl)
    _, norm_fn = make_norm(cfg)
    return norm_fn(params["final_norm"], x), cache


# ---------------------------------------------------------------------------
# convenience heads for drivers/tests
# ---------------------------------------------------------------------------

def apply_lm(params, tokens, *, cfg, vision=None, impl=None):
    """(B,S) -> (logits float32 (B,S,V), baseline (B,S)|None, aux)."""
    h, aux, _ = forward(params, tokens, cfg=cfg, vision=vision, impl=impl)
    return logits_from_hidden(params, cfg, h), \
        baseline_from_hidden(params, cfg, h), aux


def serve_step(params, tokens, cache, pos, *, cfg, impl=None):
    """(B,1) + cache -> (logits float32 (B,1,V), baseline, cache)."""
    h, cache = decode_step(params, tokens, cache, pos, cfg=cfg, impl=impl)
    return (logits_from_hidden(params, cfg, h),
            baseline_from_hidden(params, cfg, h), cache)
