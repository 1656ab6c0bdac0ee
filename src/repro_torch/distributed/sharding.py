"""The collectives of the data-parallel learner (``--mesh-data``).

The reference lays the rollout batch out over its ("data",) mesh axis
and replicates the parameters (``RL_AGENT_RULES``); the all-reduce comes
out of XLA's sharding propagation. On ``torch.distributed`` every rank is
a process holding its block of the batch and a full copy of the
parameters, and the learner calls the collectives below itself:

  ``shard_rollout``  rank r's columns ``[r*B/N, (r+1)*B/N)`` of a global
                     time-major rollout (a restored checkpoint's in-flight
                     batch, a test's global batch)
  ``replicate``      the mean over ranks of a list of tensors (the
                     gradients), in place: one flat buffer, one
                     ``all_reduce``
  ``mean_scalars``   the mean over ranks of a dict's 0-d tensors (the
                     step's metrics), stacked into one ``all_reduce``
  ``sum_floats``     host numbers summed over ranks (replay's gauges)
  ``broadcast_module``  rank 0's parameters and buffers to every rank
  ``gather_to_main`` a picklable object from every rank, on rank 0
                     (checkpoint state; CPU, the mesh's object group)
  ``rank_seed``      the seed of a rank's generators

Only ``all_reduce`` and ``broadcast`` touch tensors, so the same code runs
on NCCL, gloo over the CPU and gloo over CUDA tensors. Each takes the
``DataMesh`` of ``launch/mesh.py`` (or a ``Mesh2D``'s ``data_view()``).

The LM paths' 2-D ("data", "model") mesh (``--mesh-model``) decides which
slice of each parameter a rank holds with the reference's logical-axis
rules: ``spec_for`` maps a leaf's logical axes (``models/model.py::
logical_axes``) through a rules table to a partition spec, a tuple with
one entry per dimension (None, or the mesh axis it is split over; the
reference's ``PartitionSpec``), dropping a mapping whose dimension the
axis size does not divide and, with ``fallback_model``, splitting the
largest divisible dimension of a leaf that would otherwise keep nothing on
"model". The LM layers compute under every table of the reference
(``rules_named``): ``MEGATRON_RULES``, ``FSDP_RULES`` (every ``embed``
axis also split over the data axes), ``SEQPAR_RULES`` (the residual
stream split over "model" on its sequence dimension), ``EXPERT_RULES``
(MoE experts over "model"), their combinations, and
``CP_FSDP_SEQPAR_RULES`` (``attn_pref="seq"``: the queries stay split
over the sequence through attention, ``models/attention.py``). ``zero1_shardings`` decides the optimizer state's slices
(ZeRO-1) of ``launch/specs.py::build_train``. The collectives of the
model axis, and of the data axis of a split leaf, live beside the layers
(``models/common.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import leaves, rebuild


# ---------------------------------------------------------------------------
# The reference's rules tables (``repro.distributed.sharding``), as data
# ---------------------------------------------------------------------------

# "batch" expands to every data-like mesh axis present (pod + data)
MEGATRON_RULES: Dict[str, object] = {
    "vocab": "model",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "ssm_heads": "model",
    "conv_ch": "model",
    "act_batch": "batch",
    "act_seq": None,
    "act_embed": None,
    "act_vocab": "model",
    "expert": None,
}
FSDP_RULES = dict(MEGATRON_RULES, embed="batch")
SEQPAR_RULES = dict(MEGATRON_RULES, act_seq="model")
EXPERT_RULES = dict(MEGATRON_RULES, expert="model", mlp=None,
                    act_expert="model")
FSDP_SEQPAR_RULES = dict(MEGATRON_RULES, embed="batch", act_seq="model")
CP_FSDP_SEQPAR_RULES = dict(FSDP_SEQPAR_RULES, attn_pref="seq")
EXPERT_SEQPAR_RULES = dict(SEQPAR_RULES, expert="model", mlp=None)
RL_AGENT_RULES: Dict[str, object] = {
    "conv_h": None, "conv_w": None, "conv_in": None, "conv_out": None,
    "fc_in": None, "fc_out": None, "act_batch": "batch",
}
RULE_SETS = {
    "megatron": MEGATRON_RULES,
    "fsdp": FSDP_RULES,
    "seqpar": SEQPAR_RULES,
    "fsdp_seqpar": FSDP_SEQPAR_RULES,
    "cp_fsdp_seqpar": CP_FSDP_SEQPAR_RULES,
    "expert": EXPERT_RULES,
    "expert_seqpar": EXPERT_SEQPAR_RULES,
    "rl_agent": RL_AGENT_RULES,
}


# the tables the LM layers compute under (``rules_named``)
LM_RULES = ("megatron", "fsdp", "seqpar", "fsdp_seqpar", "cp_fsdp_seqpar",
            "expert", "expert_seqpar")


def rules_named(name: str) -> Dict[str, object]:
    """The rules table ``name`` for the LM layers; ``rl_agent`` is the
    agent's data-parallel table (``--mesh-data``), not an LM one, and is
    refused."""
    if name not in RULE_SETS:
        raise KeyError(f"unknown rules {name!r}; known: {sorted(RULE_SETS)}")
    if name not in LM_RULES:
        raise NotImplementedError(
            f"not ported yet: the {name!r} rules table (an agent table; "
            "the LM layers take " + ", ".join(LM_RULES) + ")")
    return RULE_SETS[name]


def data_axes(mesh) -> Tuple[str, ...]:
    """All batch-like axes of the mesh ('pod' + 'data' when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data", "fsdp"))


def _resolve(rule, mesh):
    if rule == "batch":
        axes = data_axes(mesh)
        return axes if len(axes) > 1 else (axes[0] if axes else None)
    return rule


def spec_for(logical_axes: Sequence[str], mesh, rules: Dict,
             shape: Optional[Sequence[int]] = None,
             fallback_model: bool = False) -> tuple:
    """Logical axes -> partition spec (a tuple, trailing Nones dropped),
    the reference's decision: a mapping whose dimension is not divisible
    by the mesh-axis size is dropped (that dimension replicated), and with
    ``fallback_model`` a leaf that uses no 'model' axis after the main pass
    splits its largest still-replicated, divisible dimension over it.
    ``mesh``: anything with ``shape`` (axis -> size) and ``axis_names``."""
    used = set()
    parts: List[Any] = []
    for i, ax in enumerate(logical_axes):
        rule = _resolve(rules.get(ax), mesh)
        if rule is None:
            parts.append(None)
            continue
        mesh_axes = rule if isinstance(rule, tuple) else (rule,)
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        if not mesh_axes:
            parts.append(None)
            continue
        size = 1
        for a in mesh_axes:
            size *= mesh.shape[a]
        if shape is not None and shape[i] % size != 0:
            parts.append(None)
            continue
        used.update(mesh_axes)
        parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    if (fallback_model and "model" not in used and shape is not None
            and "model" in mesh.shape):
        msize = mesh.shape["model"]
        for i in sorted(range(len(parts)), key=lambda i: -shape[i]):
            if parts[i] is None and shape[i] % msize == 0 \
                    and shape[i] >= msize:
                parts[i] = "model"
                break
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def param_shardings(axes: Dict[str, Sequence[str]], mesh, rules: Dict,
                    shapes: Optional[Dict[str, Sequence[int]]] = None
                    ) -> Dict[str, tuple]:
    """Leaf name -> partition spec for a table of logical axes (and, as
    the reference's, each leaf's shape: divisibility drops, and the
    'model' fallback for a leaf of more than one dimension)."""
    if shapes is None:
        return {k: spec_for(ax, mesh, rules) for k, ax in axes.items()}
    return {k: spec_for(ax, mesh, rules, shapes[k],
                        fallback_model=len(shapes[k]) > 1)
            for k, ax in axes.items()}


def axis_dim(spec: Sequence, axis: str) -> Optional[int]:
    """The dimension a partition spec splits over mesh axis ``axis``."""
    for i, part in enumerate(spec):
        if part == axis or (isinstance(part, tuple) and axis in part):
            return i
    return None


def zero1_shardings(axes: Dict[str, Sequence[str]], mesh, rules: Dict,
                    shapes: Dict[str, Sequence[int]]) -> Dict[str, tuple]:
    """Leaf name -> the partition spec of its optimizer state (ZeRO-1),
    the reference's decision: the parameter's spec, plus the data axes on
    the first still-replicated dimension they divide when the spec uses
    none of them; the parameter's spec where none divides."""
    daxes = data_axes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= mesh.shape[a]
    spec_daxes = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    out = {}
    for name, ax in axes.items():
        shape = shapes[name]
        base = spec_for(ax, mesh, rules, shape,
                        fallback_model=len(shape) > 1)
        parts: List[Any] = list(base) + [None] * (len(shape) - len(base))
        used = set()
        for p in parts:
            used.update(a for a in (p if isinstance(p, tuple) else (p,))
                        if a is not None)
        if spec_daxes is not None and not used.intersection(daxes):
            for i, p in enumerate(parts):
                if p is None and shape[i] % dsize == 0 \
                        and shape[i] >= dsize:
                    parts[i] = spec_daxes
                    break
        while parts and parts[-1] is None:
            parts.pop()
        out[name] = tuple(parts)
    return out


def batch_axes_spec(mesh, rules: Dict, ndim: int, shape,
                    batch_dim: int) -> Optional[tuple]:
    """The spec splitting ``batch_dim`` over the data axes named by the
    rules' 'act_batch' entry; None when unmapped, of size 1, or not
    divisible (the batch then stays whole on every rank)."""
    rule = _resolve(rules.get("act_batch", "batch"), mesh)
    if rule is None:
        return None
    mesh_axes = rule if isinstance(rule, tuple) else (rule,)
    size = 1
    for a in mesh_axes:
        size *= mesh.shape[a]
    if size == 1 or shape[batch_dim] % size != 0:
        return None
    parts: List[Any] = [None] * ndim
    parts[batch_dim] = mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]
    return tuple(parts)


def shard_lm_batch(batch: Dict[str, Any], mesh, rules: Dict
                   ) -> Dict[str, Any]:
    """This rank's rows of a BATCH-MAJOR LM batch (tokens (B, S+1),
    behavior_logprob / reward / done (B, S), vision (B, Sv, d)): data
    index i of D takes rows [i*B/D, (i+1)*B/D) of each leaf the rules
    split (a leaf whose B does not divide stays whole)."""
    out = {}
    for k, v in batch.items():
        spec = batch_axes_spec(mesh, rules, v.dim(), v.shape, 0)
        if spec is None:
            out[k] = v
            continue
        n = v.shape[0] // mesh.data
        out[k] = v.narrow(0, mesh.data_index * n, n).contiguous()
    return out


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generators: ``seed`` itself at rank 0
    (so world size 1 draws exactly what the single-device path draws),
    else the first 62-bit word numpy's ``SeedSequence((seed, rank))``
    generates. The reference folds the rank into a JAX key
    (``jax.random.fold_in``), which has no torch counterpart."""
    if rank == 0:
        return seed
    word = np.random.SeedSequence((seed, rank)).generate_state(1, np.uint64)
    return int(word[0] >> np.uint64(2))


def _columns(x: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    axis = 0 if x.dim() == 1 else 1     # is_replay (B,); the rest (T, B, ...)
    b = x.shape[axis]
    if b % n:
        raise ValueError(f"global batch {b} not divisible by mesh size {n}")
    return x.narrow(axis, rank * (b // n), b // n).contiguous()


def shard_rollout(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's block of the global time-major ``batch`` (tensors or
    numpy arrays), each a contiguous tensor on the input's device, as a
    rank's own source would hold it (the V-trace kernel takes contiguous
    inputs only)."""
    return {k: _columns(torch.as_tensor(v), mesh.size, mesh.rank)
            for k, v in batch.items()}


def replicate(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each tensor replaced, in place, by its mean over ranks: the list is
    flattened into one buffer, all-reduced once, divided by the world size
    and copied back. With equal blocks per rank the mean of the local
    gradients is the gradient of the global loss (the IMPALA loss sums
    over T and takes the mean over B). The results stay in the caller's
    own tensors, not in views of the buffer: a reduction over a view at
    another alignment may sum in another order (global-norm clipping's
    does on the card), and world size 1 must be bitwise the plain path.
    Returns the list."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError("replicate takes tensors of one dtype, got "
                        f"{sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.size)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))
    return list(tensors)


def mean_scalars(values: Dict[str, Any], mesh,
                 skip: Sequence[str] = ()) -> Dict[str, Any]:
    """``values`` with every 0-d tensor not named in ``skip`` replaced by
    its mean over ranks, all of them in one ``all_reduce``; no host
    synchronisation of its own."""
    keys = [k for k, v in values.items()
            if k not in skip and isinstance(v, torch.Tensor) and v.dim() == 0]
    if not keys:
        return dict(values)
    stacked = torch.stack([values[k].float() for k in keys])
    dist.all_reduce(stacked, group=mesh.group)
    stacked.div_(mesh.size)
    return dict(values, **dict(zip(keys, stacked.unbind())))


def sum_floats(values: Sequence[float], mesh) -> List[float]:
    """Host numbers summed over ranks (float64 on the mesh's device)."""
    x = torch.tensor(list(values), dtype=torch.float64, device=mesh.device)
    dist.all_reduce(x, group=mesh.group)
    return x.tolist()


def broadcast_module(module: torch.nn.Module, mesh) -> None:
    """Overwrite every rank's parameters and buffers with rank 0's."""
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=0, group=mesh.group)


def gather_to_main(obj, mesh) -> Optional[List[Any]]:
    """Every rank's ``obj`` (its tensors moved to the CPU first), as a list
    in rank order on rank 0 and None on the others."""
    obj = rebuild(obj, iter([x.detach().cpu() if isinstance(x, torch.Tensor)
                             else x for x in leaves(obj)]))
    out = [None] * mesh.size if mesh.is_main else None
    dist.gather_object(obj, out, dst=0, group=mesh.object_group)
    return out


def model_global_norm(tensors: Sequence[torch.Tensor],
                      sharded: Sequence[Tuple[bool, bool]],
                      mesh) -> torch.Tensor:
    """The global norm of a rank's gradients on a ("data", "model") mesh,
    as the norm of the whole tree: each leaf's squares are summed over
    the groups it is split over and counted once. ``sharded``: per leaf,
    (split over the model group, split over the data group: an FSDP leaf
    or a ZeRO slice)."""
    zero = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    # by (model, data): whole, model only, data only, both
    parts = [zero, zero, zero, zero]
    for t, (m, d) in zip(tensors, sharded):
        i = int(m) + 2 * int(d)
        parts[i] = parts[i] + torch.sum(torch.square(t.float()))
    whole, split = parts[0] + parts[2], parts[1] + parts[3]
    if mesh.data > 1 and any(d for _, d in sharded):
        over_data = torch.stack([parts[2], parts[3]])
        dist.all_reduce(over_data, group=mesh.data_group)
        whole, split = parts[0] + over_data[0], parts[1] + over_data[1]
    if mesh.model > 1:
        split = split.clone()
        dist.all_reduce(split, group=mesh.model_group)
    return torch.sqrt(split + whole)
