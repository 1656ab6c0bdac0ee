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
layout, so ``wq`` stays (d, H, hd), ``wo`` (H, hd, d) and a Mamba2 layer's
``conv_w`` (W, C). The Zamba2 hybrids' shared block (``shared.l0...``) is
not stacked in either package and goes across as it is.
"""

from __future__ import annotations

from typing import Any, Dict

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
