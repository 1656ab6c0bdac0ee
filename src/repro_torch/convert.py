"""Parameter trees between the JAX reference and this package.

Conv agents. The reference keeps agent parameters as nested dicts/lists of arrays
(``models/common.py::split_params`` values): conv ``w`` in HWIO, linear
``w`` as (din, dout), and ``b``. A port module's ``state_dict`` names the
same leaves by their dotted path (``sections.0.res.1.c2.weight``), with
conv weights in OIHW and linear weights as ``nn.Linear``'s (dout, din).

LM decoders. The reference's tree (``models.model.init(...)[0]``) stacks
every block leaf on a leading ``num_groups`` axis; the port's
``models.model.init`` keeps one node per group (``blocks.<g>.l0.mixer.wq``).
The converter unstacks and restacks that axis and keeps every leaf's
layout, so ``wq`` stays (d, H, hd), ``wo`` (H, hd, d), a Mamba2 layer's
``conv_w`` (W, C), an MoE layer's ``router`` (d, E), ``wi``/``wg``
(E, d, f) and ``wo`` (E, f, d), an mLSTM layer's ``wq``/``wk``/``wv``
(d, H, dh), ``wi``/``wf`` (d, H), ``bf``, ``wo_gate`` and ``wo`` (d, d)
and ``norm``, and an sLSTM layer's ``wx`` (d, 4, H, dh), ``wr`` (4, H,
dh, dh), ``b``, ``norm``, ``up`` (d, 2d) and ``down`` (d, d). The
Zamba2 hybrids' shared block
(``shared.l0...``) is not stacked in either package and goes across as it
is.

LM checkpoints. ``LMCheckpointLayout`` maps a learner checkpoint's leaves
(the parameters and the optimizer state, whose lists follow the
parameters' order) to the reference's keys and back, so either package
resumes the other's ``--mode lm`` / ``--mode lm-rl`` checkpoints.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch


def _weight_to_torch(w):
    w = np.asarray(w, np.float32)
    if w.ndim == 4:                      # HWIO -> OIHW
        return w.transpose(3, 2, 0, 1)
    if w.ndim == 2:                      # (din, dout) -> (dout, din)
        return w.T
    raise ValueError(f"unexpected weight rank {w.ndim}")


def _weight_to_jax(w):
    return w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T


def state_dict_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy or jax arrays) -> a port ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, child in items:
            path = f"{prefix}{key}"
            if key == "w":
                out[f"{prefix}weight"] = torch.tensor(
                    _weight_to_torch(child))
            elif key == "b":
                out[f"{prefix}bias"] = torch.tensor(
                    np.asarray(child, np.float32))
            else:
                walk(child, path + ".")

    walk(tree, "")
    return out


def state_dict_to_jax(state_dict) -> Dict[str, Any]:
    """A port ``state_dict`` -> the JAX param tree layout, as numpy."""
    root: Dict[str, Any] = {}
    for name, value in state_dict.items():
        *path, leaf = name.split(".")
        node = root
        for key in path:
            node = node.setdefault(key, {})
        arr = value.detach().cpu().numpy()
        node["w" if leaf == "weight" else "b"] = (
            np.ascontiguousarray(_weight_to_jax(arr)) if leaf == "weight"
            else arr)

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def lm_state_dict_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX LM param tree (numpy or jax arrays) -> a ``state_dict`` of
    ``models.model.init``'s tree, float32."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix, group=None):
        for key, child in node.items():
            if isinstance(child, dict):
                walk(child, f"{prefix}{key}.", group)
                continue
            arr = np.asarray(child, np.float32)
            if group is None:
                out[f"{prefix}{key}"] = torch.tensor(arr)
            else:
                for g in range(arr.shape[0]):
                    out[f"{group}.{g}.{prefix}{key}"] = torch.tensor(arr[g])

    for key, child in tree.items():
        if key == "blocks":
            walk(child, "", group="blocks")
        elif isinstance(child, dict):
            walk(child, f"{key}.")
        else:
            out[key] = torch.tensor(np.asarray(child, np.float32))
    return out


def lm_state_dict_to_jax(state_dict) -> Dict[str, Any]:
    """A ``models.model.init`` ``state_dict`` -> the JAX LM param tree, as
    numpy, with the block leaves stacked on a leading group axis."""
    root: Dict[str, Any] = {}
    stacked: Dict[str, Dict[int, np.ndarray]] = {}
    for name, value in state_dict.items():
        arr = value.detach().cpu().numpy()
        if name.startswith("blocks."):
            _, g, rest = name.split(".", 2)
            stacked.setdefault(rest, {})[int(g)] = arr
            continue
        *path, leaf = name.split(".")
        node = root
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    for rest, by_group in stacked.items():
        *path, leaf = rest.split(".")
        node = root.setdefault("blocks", {})
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.stack([by_group[g] for g in sorted(by_group)])
    return root


class LMCheckpointLayout:
    """The reference's on-disk layout of an LM learner's checkpoint.

    The port's learner tree is {"params": state_dict, "opt_state": {slot:
    [tensor per parameter]}}, whose leaves the checkpoint names
    ``params/blocks.3.l0.mixer.wq`` and ``opt_state/mu/#17``. The
    reference's is {"params": tree, "opt_state": {slot: tree}} (AdamW:
    {"mu": tree, "nu": tree}), every block leaf stacked on the group axis:
    ``params/blocks/l0/mixer/wq`` and ``opt_state/mu/blocks/l0/mixer/wq``.
    ``names`` are the parameter names in the order of the optimizer
    state's lists (``params.named_parameters()``).

    A model-parallel rank's layout also takes ``model_layout`` (name ->
    (the reference's spec, the split dimension of the port's leaf or
    None, its whole shape): ``models/model.py::shard_model``) and the
    ``mesh``: its leaves are then slices, and ``disk_layout`` gives each
    disk key's whole (stacked) shape, the global index of this rank's
    block, the spec, and whether this rank writes it."""

    def __init__(self, names: Sequence[str], model_layout=None, mesh=None):
        self.names = list(names)
        self.model_layout = model_layout
        self.mesh = mesh

    def disk_layout(self, keys: Sequence[str]) -> Dict[str, dict]:
        """Disk key -> {"shape", "index", "spec", "write"} of this rank for
        the port's ``keys`` (``checkpoint.Snapshot.layout``; ``restore``'s
        ``shardings`` take its (shape, index)). A split leaf's slice is
        written by the ranks of data index 0 (one writer a slice), a whole
        leaf by rank 0."""
        mesh = self.mesh
        out: Dict[str, dict] = {}
        groups: Dict[str, int] = {}
        for key in keys:
            where, group = self._where(key)
            if group is not None:
                groups[where] = max(groups.get(where, 0), group + 1)
            name = key.partition("/")[2] if key.startswith("params/") \
                else self.names[int(key.rsplit("#", 1)[1])]
            spec, dim, shape = self.model_layout[name]
            if dim == "layers" or "data" in str(spec):
                raise NotImplementedError(
                    f"not ported yet: a sharded checkpoint of {name} split "
                    f"as {spec} (the reference writes none under the "
                    "rules tables other than Megatron)")
            index = [[0, d] for d in shape]
            if dim is not None:
                n = shape[dim] // mesh.model
                index[dim] = [mesh.model_index * n,
                              (mesh.model_index + 1) * n]
            out[where] = {
                "shape": list(shape), "index": index,
                "spec": [list(p) if isinstance(p, tuple) else p
                         for p in spec],
                "write": mesh.data_index == 0 if dim is not None
                else mesh.rank == 0}
        for where, g in groups.items():
            entry = out[where]
            entry["shape"] = [g] + entry["shape"]
            entry["index"] = [[0, g]] + entry["index"]
        return out

    def _where(self, key: str) -> Tuple[str, Any]:
        """(the reference's key, the group index or None) of a port key."""
        tree, _, rest = key.partition("/")
        if tree == "params":
            prefix, name = tree, rest
        else:
            slot, index = rest.split("/")
            prefix, name = f"{tree}/{slot}", self.names[int(index[1:])]
        if name.startswith("blocks."):
            _, group, sub = name.split(".", 2)
            return f"{prefix}/blocks/{sub.replace('.', '/')}", int(group)
        return f"{prefix}/{name.replace('.', '/')}", None

    def to_disk(self, leaves: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The port's flat leaves (host arrays) under the reference's
        keys, block leaves stacked. Consumes ``leaves`` as it goes, so
        the host holds one copy of the state and one stacked leaf."""
        out: Dict[str, np.ndarray] = {}
        stacked: Dict[str, Dict[int, np.ndarray]] = {}
        for key in list(leaves):
            where, group = self._where(key)
            if group is None:
                out[where] = leaves.pop(key)
            else:
                stacked.setdefault(where, {})[group] = leaves.pop(key)
        for where in list(stacked):
            by_group = stacked.pop(where)
            out[where] = np.stack([by_group[g] for g in sorted(by_group)])
        return out

    def template(self, shapes: Sequence[Tuple[str, Sequence[int]]]):
        """A tree in the reference's layout whose leaves carry only the
        shapes (zero-stride views), from the port's (key, shape) pairs:
        the ``like`` that ``checkpoint.restore`` checks a checkpoint
        against before it reads any array."""
        groups: Dict[str, List[Any]] = {}
        for key, shape in shapes:
            where, group = self._where(key)
            groups.setdefault(where, []).append((group, tuple(shape)))
        root: Dict[str, Any] = {}
        for where, entries in groups.items():
            shape = entries[0][1]
            if entries[0][0] is not None:
                shape = (len(entries),) + shape
            *path, leaf = where.split("/")
            node = root
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = np.broadcast_to(np.zeros((), np.float32), shape)
        return root

    def from_disk(self, flat: Dict[str, np.ndarray],
                  keys: Sequence[str]) -> Dict[str, np.ndarray]:
        """The arrays of the port's ``keys`` from a checkpoint's flat
        leaves in the reference's layout (a group's slice of a stacked
        leaf is a view)."""
        out = {}
        for key in keys:
            where, group = self._where(key)
            out[key] = flat[where] if group is None else flat[where][group]
        return out
