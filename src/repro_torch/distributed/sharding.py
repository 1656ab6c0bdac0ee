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
``DataMesh`` of ``launch/mesh.py``. The reference's other rule tables
(``MEGATRON_RULES``, ``FSDP_RULES``, ...) belong to the LM meshes
(ROADMAP item 20).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import leaves, rebuild


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
