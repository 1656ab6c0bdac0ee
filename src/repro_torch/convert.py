"""Parameter trees between the JAX reference and this package.

The reference keeps agent parameters as nested dicts/lists of arrays
(``models/common.py::split_params`` values): conv ``w`` in HWIO, linear
``w`` as (din, dout), and ``b``. A port module's ``state_dict`` names the
same leaves by their dotted path (``sections.0.res.1.c2.weight``), with
conv weights in OIHW and linear weights as ``nn.Linear``'s (dout, din).
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
