"""Shared decoder building blocks: the parameter tree, initialisers, norms,
rotary and sinusoidal position embeddings, softcap.

The reference keeps a decoder's parameters as nested dicts of arrays. Here
the same tree is a tree of :class:`Params` modules: each node holds named
``nn.Parameter`` leaves and child nodes, read with ``[]`` as the
reference's dicts are, so ``params["mixer"]["wq"]`` reads the same in both
packages. Leaves keep the reference's layouts (``wq`` as (d, H, hd), ``wo``
as (H, hd, d)), and a node's ``state_dict`` names each leaf by its path.

Model parallel (``--mesh-model``). The reference places each leaf by its
logical axes (``distributed/sharding.py::spec_for``) and lets XLA insert
the collectives. Here a rank's tree holds its slice of each split leaf
(``shard_params``; the node's ``shard_dims`` names the split dimension of
each of its leaves) and the layers call the collectives themselves, as
Megatron does, inside a ``use_rules(mesh, rules)`` context:

  ``copy_to_model``    identity forward, all-reduce backward: where a
                       replicated activation (or leaf) enters rank-local
                       work, whose gradients are partial sums
  ``reduce_from_model``  all-reduce forward, identity backward: the
                       partial outputs of a row-parallel product
  ``gather_from_model``  a leaf's slices concatenated (a zero-padded
                       all-reduce), backward the rank's own slice of the
                       (replicated) gradient; the gathered leaf is kept,
                       across steps and calls, until the leaf changes in
                       place or is freed

Under the other rules tables three more boundaries come in, each an
``autograd.Function`` whose backward is its forward's transpose:

  ``gather_from_data``  FSDP: a leaf split over the data group gathered at
                       use (all-gather), its gradient reduce-scattered
  ``gather_seq``       sequence parallel: the residual's sequence shards
                       gathered after the pre-norm (all-gather; with the
                       layer's ``copy_to_model`` its backward is the
                       reduce-scatter)
  ``scatter_seq``      the rank's sequence shard of a sublayer's output
                       (with the layer's ``reduce_from_model``, a
                       reduce-scatter; backward an all-gather)

``collective_stats`` counts each by group and kind.

``operand(node, name, want, local)`` hands a layer a leaf in the layout
its arithmetic needs: split on ``want`` or whole, gathered or sliced from
whatever the rules left it as, and behind ``copy_to_model`` where its use
is rank-local. Outside a context, or with a model axis of 1, every one of
these is the identity, so the unmeshed path runs unchanged, bit for bit.
Every collective is an ``all_reduce`` (or a ``broadcast``): gloo over CUDA
tensors, which lets two ranks share one card, takes those.
"""

from __future__ import annotations

import contextlib
import math
import time
import weakref

import torch
import torch.distributed as dist
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

    @property
    def shard_dims(self) -> dict:
        """Leaf name -> the dimension this rank holds a model slice of
        (leaves held whole are absent)."""
        return self.__dict__.get("_shard_dims", {})

    @property
    def owners(self) -> dict:
        """Leaf name -> (the model index holding it whole, its shape) for
        a leaf split over "model" on the reference's stacked layers axis
        (held empty on the other model ranks)."""
        return self.__dict__.get("_owners", {})

    @property
    def data_dims(self) -> dict:
        """Leaf name -> the dimension this rank holds a data slice of
        (FSDP; absent elsewhere)."""
        return self.__dict__.get("_data_dims", {})


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
    backward pass, which runs ``fn`` (and its kernels) a second time.

    No region draws a random number (the decoders have no dropout), so no
    RNG state is stashed: stashing reads the CUDA generator's state, which
    a CUDA graph capture of a learner step refuses."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


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
    return (y * (1.0 + operand(params, "scale").float())).to(dt)


def split_rmsnorm(scale, x, dim, eps):
    """``rmsnorm`` over the whole ``dim`` channels of which ``x`` holds
    this rank's share (a model-split layer's output): the sum of squares
    summed over the model group; ``scale`` the rank's slice."""
    dt = x.dtype
    xf = x.float()
    var = sum_over_model(torch.sum(torch.square(xf), dim=-1, keepdim=True)
                         ) / dim
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


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
    y = y * (1.0 + operand(params, "scale").float()) \
        + operand(params, "bias").float()
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


# ---------------------------------------------------------------------------
# Model parallel: the rules context, the boundary functions, the slicer
# ---------------------------------------------------------------------------

_RULES = None            # (mesh, rules) of the active use_rules context
_GATHERED: dict = {}     # gather_from_model's leaves: key -> (ref, v, whole)


@contextlib.contextmanager
def use_rules(mesh, rules):
    """Run the layers inside with ``mesh``'s model axis (a ``Mesh2D``) and
    the rules table ``rules``; ``mesh=None`` leaves the context as it is
    (none: the unmeshed path). The context is the process's (each rank
    is a process of its own)."""
    global _RULES
    prev = _RULES
    if mesh is not None:
        _RULES = (mesh, rules)
    try:
        yield
    finally:
        _RULES = prev


def model_mesh():
    """The active mesh when its model axis is larger than 1, else None:
    the one test every layer makes."""
    if _RULES is None or _RULES[0].model == 1:
        return None
    return _RULES[0]


def model_split(n: int) -> int:
    """How many parts a dimension of size ``n`` is split into: the model
    axis's size when a model-parallel context is active and it divides
    ``n``, else 1."""
    mesh = model_mesh()
    return mesh.model if mesh is not None and n % mesh.model == 0 else 1


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        mesh = _RULES[0]
        out = x.detach().clone()
        dist.all_reduce(out, group=mesh.data_group)
        return out.div_(mesh.data)

    @staticmethod
    def backward(ctx, g):
        return g


def data_mean(x):
    """The mean of ``x`` over the data group (a statistic of the whole
    batch, where each rank holds its block), its gradient passed to the
    rank's own ``x`` unscaled: the learner's mean of the ranks' gradients
    is then the whole batch's. Identity without a data axis."""
    if _RULES is None or _RULES[0].data == 1:
        return x
    return _DataMean.apply(x)


_COLLECTIVES: dict = {"calls": 0, "bytes": 0, "seconds": 0.0, "by": {}}


def collective_stats() -> dict:
    """The collectives of the layers since ``reset_collective_stats``:
    calls, bytes moved (a rank's tensor: the whole one of an all-reduce
    or an all-gather's result, the input of a reduce-scatter) and host
    seconds inside them (each waits for the work queued before it; gloo
    stages a CUDA tensor through the host), in total and under "by",
    keyed ``"<group>/<kind>"`` (group ``model`` or ``data``; kind
    ``all_reduce``, ``all_gather`` or ``reduce_scatter``)."""
    out = dict(_COLLECTIVES)
    out["by"] = {k: dict(v) for k, v in _COLLECTIVES["by"].items()}
    return out


def reset_collective_stats() -> None:
    _COLLECTIVES.update(calls=0, bytes=0, seconds=0.0, by={})


def count_collective(group, kind, nbytes, seconds) -> None:
    """Add one collective's bytes and host seconds to the counts."""
    for entry in (_COLLECTIVES, _COLLECTIVES["by"].setdefault(
            f"{group}/{kind}", {"calls": 0, "bytes": 0, "seconds": 0.0})):
        entry["seconds"] += seconds
        entry["calls"] += 1
        entry["bytes"] += nbytes


def collective(x, group, kind, op=dist.ReduceOp.SUM, mesh=None):
    """``x`` all-reduced in place over ``mesh``'s (default: the active
    context's) ``group`` ("model" or "data"), counted as ``kind``. Every
    collective of the layers and the learner is an all-reduce: an
    all-gather is one over a zero-padded buffer (exact), a reduce-scatter
    one followed by the rank's slice; gloo over CUDA tensors, which lets
    ranks share one card, takes only these."""
    mesh = _RULES[0] if mesh is None else mesh
    x = x.contiguous()
    t0 = time.perf_counter()
    dist.all_reduce(x, op=op, group=getattr(mesh, f"{group}_group"))
    count_collective(group, kind, x.numel() * x.element_size(),
                     time.perf_counter() - t0)
    return x


def _all_reduce(x, op=dist.ReduceOp.SUM):
    return collective(x, "model", "all_reduce", op)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone())


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x):
    """Identity forward; the gradient summed over the model group."""
    return x if model_mesh() is None else _CopyToModel.apply(x)


def reduce_from_model(x):
    """``x`` summed over the model group; the gradient passes as it is."""
    return x if model_mesh() is None else _ReduceFromModel.apply(x)


def sum_over_model(x):
    """``x`` summed over the model group where each rank's share of the
    result's gradient is itself partial (a norm's sum of squares over a
    split dimension): the sum forward and backward."""
    return copy_to_model(reduce_from_model(x))


def max_over_model(x):
    """The elementwise max over the model group, without a gradient."""
    if model_mesh() is None:
        return x
    return _all_reduce(x.detach().clone(), dist.ReduceOp.MAX)


def rule(name):
    """The active rules table's entry for logical axis ``name`` (None
    outside a context)."""
    return None if _RULES is None else _RULES[1].get(name)


def data_mesh():
    """The active mesh when its data axis is larger than 1, else None."""
    if _RULES is None or _RULES[0].data == 1:
        return None
    return _RULES[0]


def _pad_to_full(x, dim, parts, index):
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * parts
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, index * n, n).copy_(x)
    return full


def gather_model_slices(x, dim):
    """The model group's slices of ``x`` (each rank's its own, along
    ``dim``) concatenated in model order, on every rank, no gradient: a
    zero-padded buffer summed over the group, exact."""
    mesh = model_mesh()
    if mesh is None:
        return x
    return collective(_pad_to_full(x.detach(), dim, mesh.model,
                                    mesh.model_index), "model", "all_gather")


def _own(x, dim, parts, index):
    n = x.shape[dim] // parts
    return x.narrow(dim, index * n, n).contiguous()


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return gather_model_slices(x, dim)

    @staticmethod
    def backward(ctx, g):
        mesh = model_mesh()
        return _own(g, ctx.dim, mesh.model, mesh.model_index), None


class _ScatterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        mesh = model_mesh()
        return _own(x, dim, mesh.model, mesh.model_index)

    @staticmethod
    def backward(ctx, g):
        return gather_model_slices(g, ctx.dim), None


def gather_model(x, dim):
    """An activation split along ``dim`` over the model group made whole
    on every rank (all-gather); backward, the rank's slice of the
    gradient. Where the whole activation then enters rank-local work,
    that work's ``copy_to_model`` sums the gradient's parts first, and
    the two together are the all-gather's transpose, a reduce-scatter
    (where it enters replicated work the gradient is already whole)."""
    return x if model_mesh() is None else _GatherModel.apply(x, dim)


def scatter_model(x, dim):
    """The rank's slice along ``dim`` of an activation whole on every
    rank; backward, the slices' gradients gathered (all-gather). After a
    row-parallel product's ``reduce_from_model`` the two together are a
    reduce-scatter of its partial sums."""
    return x if model_mesh() is None else _ScatterModel.apply(x, dim)


# sequence parallel (``act_seq`` -> "model"): the residual stream lies
# split over the model group on its sequence dimension between sublayers
_SEQ_LOCAL = False


def seq_parallel(seq_len: int) -> bool:
    """Whether the active rules split a residual stream of ``seq_len``
    tokens over the model axis (the reference's ``act_seq`` mapping; a
    length the axis does not divide, such as a decode token, stays
    whole, as ``spec_for`` drops it)."""
    mesh = model_mesh()
    return (mesh is not None and rule("act_seq") == "model"
            and seq_len % mesh.model == 0)


def gather_seq(x):
    """A sequence-split residual (B, S/M, ...) made whole, (B, S, ...):
    ``gather_model`` on dimension 1 (the reference's ``gather_seq``)."""
    return gather_model(x, 1)


def scatter_seq(x):
    """The rank's sequence shard of a whole (B, S, ...) activation:
    ``scatter_model`` on dimension 1."""
    return scatter_model(x, 1)


@contextlib.contextmanager
def seq_local():
    """Inside: every whole leaf that ``operand`` hands out is used in
    rank-local work (a norm over the rank's sequence shard), so its
    gradient is summed over the model group."""
    global _SEQ_LOCAL
    prev, _SEQ_LOCAL = _SEQ_LOCAL, True
    try:
        yield
    finally:
        _SEQ_LOCAL = prev


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        mesh = _RULES[0]
        ctx.dim = dim
        return collective(_pad_to_full(x.detach(), dim, mesh.data,
                                        mesh.data_index), "data",
                           "all_gather")

    @staticmethod
    def backward(ctx, g):
        mesh = _RULES[0]
        full = collective(g.clone(), "data", "reduce_scatter")
        return _own(full, ctx.dim, mesh.data, mesh.data_index), None


class _GatherOwned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, owner, shape):
        mesh = model_mesh()
        ctx.mine = owner == mesh.model_index
        buf = x.detach().clone() if ctx.mine else torch.zeros(
            shape, dtype=x.dtype, device=x.device)
        return collective(buf, "model", "all_gather")

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else g.narrow(0, 0, 0)), None, None


def gather_owned(x, owner, shape):
    """A leaf that one model rank (``owner``) holds whole and the others
    hold empty (the reference splits its stacked ``layers`` axis over
    "model": each group's leaf lies on one rank), made whole on every
    rank; backward, the owner keeps the gradient, which must be the same
    on every rank (a replicated use, or one behind ``copy_to_model``)."""
    return _GatherOwned.apply(x, owner, tuple(shape))


def gather_from_data(x, dim):
    """A leaf split along ``dim`` over the data group (FSDP: the rules
    map its ``embed`` axis to the data axes) made whole at its use
    (all-gather); backward, the data ranks' gradients summed and the
    rank's slice kept (reduce-scatter), so the learner divides it by the
    data size instead of all-reducing it."""
    return x if data_mesh() is None else _GatherFromData.apply(x, dim)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        mesh = model_mesh()
        ctx.dim, ctx.index = dim, mesh.model_index
        # one entry a leaf, replaced when the leaf changes in place (its
        # version) or is another tensor at the same address (the weakref)
        key = (x.data_ptr(), tuple(x.shape), dim)
        ref, version, full = _GATHERED.get(key, (None, None, None))
        if ref is None or ref() is not x or version != x._version:
            for k in [k for k, v in _GATHERED.items() if v[0]() is None]:
                del _GATHERED[k]          # leaves that no longer exist
            full = gather_model_slices(x, dim)
            _GATHERED[key] = (weakref.ref(x), x._version, full)
        return full.clone()

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // model_mesh().model
        return g.narrow(ctx.dim, ctx.index * n, n).contiguous(), None


def gather_from_model(x, dim):
    """A leaf split along ``dim`` made whole on every rank; its backward
    takes the rank's slice of the gradient, which must be the same on
    every rank (a replicated use, or one behind ``copy_to_model``)."""
    return x if model_mesh() is None else _GatherFromModel.apply(x, dim)


def local_slice(x, dim):
    """This rank's contiguous share of ``x`` along ``dim``."""
    mesh = model_mesh()
    n = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_index * n, n)


def full_size(node, name, dim) -> int:
    """The whole leaf's size along ``dim`` (the slice's times the model
    or data axis where this rank holds a slice along it)."""
    if name in getattr(node, "owners", {}):
        return node.owners[name][1][dim]
    size = node[name].shape[dim]
    mesh = model_mesh()
    if mesh is not None and node.shard_dims.get(name) == dim:
        size *= mesh.model
    if data_mesh() is not None and node.data_dims.get(name) == dim:
        size *= data_mesh().data
    return size


def operand(node, name, want=None, local=False):
    """Leaf ``name`` of ``node`` as the layer's arithmetic needs it: split
    along ``want`` (this rank's contiguous slice) or whole (``want``
    None), whatever the rules split it on. ``local``: the whole leaf is
    used in rank-local work, whose gradient each rank has only a part
    of. A leaf used split is always rank-local. Outside a model-parallel
    context: the leaf itself."""
    x = node[name]
    split = getattr(node, "data_dims", {}).get(name)
    if split is not None and data_mesh() is not None:
        x = gather_from_data(x, split)
    if model_mesh() is None:
        return x
    owner = getattr(node, "owners", {}).get(name)
    if owner is not None:
        x = gather_owned(x, *owner)
    local = local or _SEQ_LOCAL
    have = getattr(node, "shard_dims", {}).get(name)
    if have == want:
        return copy_to_model(x) if want is None and local else x
    if have is not None:
        x = gather_from_model(x, have)
    if want is None:
        return copy_to_model(x) if local else x
    return local_slice(copy_to_model(x), want)


def shard_params(params, dims, mesh, data_dims=None, owners=None):
    """Cut the whole tree ``params`` down to ``mesh``'s slice, in place:
    each leaf named in ``dims`` (state-dict name -> dimension, as
    ``models/model.py::param_specs`` decides it) keeps its contiguous
    slice ``model_index`` of ``mesh.model`` along that dimension, and
    each named in ``data_dims`` its slice ``data_index`` of ``mesh.data``
    along that one (FSDP: a leaf may be split on both). A leaf named in
    ``owners`` (name -> model index) stays whole on that model rank and
    becomes empty on the others. Every node records its leaves' layout in
    ``shard_dims``, ``data_dims`` and ``owners``. Returns ``params``."""
    data_dims, owners = data_dims or {}, owners or {}
    for path, node in params.named_modules():
        for record in ("_shard_dims", "_data_dims", "_owners"):
            node.__dict__[record] = {}
        for name, leaf in list(node._parameters.items()):
            full = f"{path}.{name}" if path else name
            part, cut = leaf.detach(), False
            owner = owners.get(full)
            if owner is not None and mesh.model > 1:
                node.__dict__["_owners"][name] = (owner, tuple(leaf.shape))
                if owner != mesh.model_index:
                    node._parameters[name] = nn.Parameter(
                        part.narrow(0, 0, 0).clone())
                    continue
            for dim, parts, index, record in (
                    (dims.get(full), mesh.model, mesh.model_index,
                     "_shard_dims"),
                    (data_dims.get(full), mesh.data, mesh.data_index,
                     "_data_dims")):
                if dim is None or parts == 1:
                    continue
                n = part.shape[dim] // parts
                part, cut = part.narrow(dim, index * n, n), True
                node.__dict__[record][name] = dim
            if cut:
                node._parameters[name] = nn.Parameter(part.clone())
    return params
