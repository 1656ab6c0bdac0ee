"""Trees: dicts, lists and tuples (NamedTuples included) around leaves.

The one container walk that the batcher's stacking, the checkpoint's
leaf keys and the sources' state restore share. A leaf's path joins dict
keys as they are and sequence positions as ``#i`` with ``/``
(``params/conv.weight``, ``opt_state/ms/#0``), as the reference's
checkpoints name them.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of ``tree``, in order."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flatten(v, f"{prefix}/{k}" if prefix else k)
    return out


def leaves(tree) -> List[Any]:
    """The leaves of ``tree``, in the order ``rebuild`` takes them."""
    return [leaf for _, leaf in flatten(tree)]


def rebuild(tree, leaves: Iterator[Any]):
    """``tree``'s containers around leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return type(tree)((k, rebuild(v, leaves)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, leaves) for v in tree)
    return next(leaves)


def map_leaves(fn: Callable[[Any], Any], tree):
    """``tree`` with ``fn`` applied to every leaf."""
    return rebuild(tree, iter([fn(x) for x in leaves(tree)]))
