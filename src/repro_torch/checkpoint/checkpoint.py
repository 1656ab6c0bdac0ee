"""Manifest checkpoints, single process.

A checkpoint is a DIRECTORY, in the same on-disk format as the reference
package's (``_FORMAT`` 2), so each package reads the other's:

    step_40/
      shard-00000.npz    the process's arrays: every learner-tree leaf and
                         the process's structured (source) state
      shard-00000.json   sidecar: index/shape/dtype per leaf, structured
                         schema, metadata
      manifest.json      written LAST — the COMPLETION MARKER

All file writes are write-to-temp + ``os.replace``, and readers treat a
step directory without ``manifest.json`` as nonexistent, so a kill at ANY
point during a save leaves the previous checkpoint as the latest
restorable one.

Two content layers:

* ``save``/``restore`` — fixed-structure trees (a module's
  ``state_dict()``, the optimizer state's lists of tensors), restored
  into a ``like`` template whose structure is checked up front. This is
  the learner-state path.
* ``structured=``/``restore_structured`` — SELF-DESCRIBING trees whose
  shape is only known at save time (RolloutSource ``state_dict()``s: env
  carries, generator states, in-flight rollouts — any nesting of
  dict/list/tuple/None/scalar/array or tensor).

Trees are dicts, lists and tuples; a leaf's key is its path as
``repro_torch.tree.flatten`` gives it (``params/conv.weight``,
``opt_state/ms/#0``), as the reference names them.

The snapshot/write split (``snapshot()`` -> ``write_snapshot()``) moves
checkpointing off the hot path: ``snapshot`` synchronously COPIES every
leaf to host memory (the learner updates its tensors in place, so a view
would change under the writer), and ``write_snapshot`` — all the disk
I/O — runs wherever the caller likes, e.g. the background thread of
``checkpoint.writer.AsyncCheckpointWriter``.

Not here: the multi-process completion barrier and the sharded, elastic
restore onto a device mesh, and the reader of the reference's legacy
single-file ``step_N.npz`` (a format this package never wrote).
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, rebuild

MANIFEST = "manifest.json"
_FORMAT = 2
_STRUCT_PREFIX = "__structured__/"
_SHARD_NPZ = "shard-00000.npz"
_SHARD_JSON = "shard-00000.json"


def _host_copy(x) -> np.ndarray:
    """A host numpy COPY of a tensor or array leaf (never a view)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _atomic_write(path: str, write_fn) -> None:
    """Write via ``write_fn(file_object)`` to a temp file in the target
    directory, then ``os.replace`` — readers never observe a torn file."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


# ---------------------------------------------------------------------------
# structured (self-describing) encode/decode
# ---------------------------------------------------------------------------


def _encode(obj, flat: Dict[str, Any], path: str) -> dict:
    """Encode a tree into (flat arrays, JSON schema). Scalars live in the
    schema; array and tensor leaves are COPIED into ``flat`` under
    ``path``. NamedTuples degrade to plain tuples — restore against a live
    template when the node type matters."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return {"t": "py", "v": obj.item()}
    if isinstance(obj, dict):
        return {"t": "dict", "items": {
            str(k): _encode(v, flat, f"{path}/{k}") for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"t": "tuple" if isinstance(obj, tuple) else "list",
                "items": [_encode(v, flat, f"{path}/{i}")
                          for i, v in enumerate(obj)]}
    arr = _host_copy(obj)
    if arr.dtype == object:
        raise TypeError(f"cannot checkpoint object-dtype leaf at {path!r}")
    flat[path] = arr
    return {"t": "arr", "k": path}


def _decode(node: dict, data) -> Any:
    t = node["t"]
    if t == "none":
        return None
    if t == "py":
        return node["v"]
    if t == "dict":
        return {k: _decode(v, data) for k, v in node["items"].items()}
    if t == "list":
        return [_decode(v, data) for v in node["items"]]
    if t == "tuple":
        return tuple(_decode(v, data) for v in node["items"])
    if t == "arr":
        return np.asarray(data[node["k"]])
    raise ValueError(f"unknown schema node type {t!r}")


# ---------------------------------------------------------------------------
# snapshot: synchronous copy of every leaf to host memory
# ---------------------------------------------------------------------------


@dataclass
class Snapshot:
    """Host-side copy of everything one checkpoint holds — safe to hand to
    a background writer while training mutates the live tensors."""
    leaves: Dict[str, np.ndarray]
    structured: Dict[str, dict] = field(default_factory=dict)   # schemas
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)  # npz extras


def snapshot(tree, structured: Optional[Dict[str, Any]] = None) -> Snapshot:
    """Copy every leaf of ``tree`` (and of any ``structured`` trees) to
    host memory. This is the only part of a save that must run
    synchronously with training; hand the result to ``write_snapshot`` (or
    an ``AsyncCheckpointWriter``) for the disk I/O."""
    snap = Snapshot(leaves={key: _host_copy(leaf)
                            for key, leaf in flatten(tree)})
    for name, obj in (structured or {}).items():
        if obj is None:
            continue
        snap.structured[name] = _encode(obj, snap.arrays,
                                        _STRUCT_PREFIX + name)
    return snap


def write_snapshot(path: str, snap: Snapshot,
                   metadata: Optional[dict] = None) -> None:
    """Persist a ``Snapshot`` under checkpoint directory ``path``: the
    shard arrays, the sidecar, then the ``manifest.json`` completion
    marker."""
    os.makedirs(path, exist_ok=True)
    arrays = dict(snap.arrays)
    tree_entries: Dict[str, dict] = {}
    for key, arr in snap.leaves.items():
        arrays[f"{key}@0"] = arr
        tree_entries[key] = {
            "shape": list(arr.shape), "dtype": str(arr.dtype), "spec": None,
            "shards": [{"key": f"{key}@0",
                        "index": [[0, d] for d in arr.shape]}]}
    _atomic_write(os.path.join(path, _SHARD_NPZ),
                  lambda f: np.savez(f, **arrays))
    sidecar = {"process": 0, "tree": tree_entries,
               "structured": snap.structured, "mesh": None,
               "metadata": metadata or {}}
    _atomic_write(os.path.join(path, _SHARD_JSON),
                  lambda f: f.write(json.dumps(sidecar).encode()))
    manifest = {
        "format": _FORMAT, "num_processes": 1,
        "metadata": metadata or {}, "mesh": None,
        "tree": {key: dict(entry, shards=[dict(s, file=_SHARD_NPZ)
                                          for s in entry["shards"]])
                 for key, entry in tree_entries.items()},
        "structured": {name: {"0": {"file": _SHARD_NPZ, "schema": schema}}
                       for name, schema in snap.structured.items()}}
    _atomic_write(os.path.join(path, MANIFEST),
                  lambda f: f.write(json.dumps(manifest).encode()))


def save(path: str, tree, metadata: dict | None = None,
         structured: Dict[str, Any] | None = None) -> None:
    """Synchronous save: ``snapshot`` + ``write_snapshot``. ``structured``:
    optional name -> self-describing tree (see module docstring); read
    back with ``restore_structured(path, name)``."""
    write_snapshot(path, snapshot(tree, structured), metadata)


# ---------------------------------------------------------------------------
# read side
# ---------------------------------------------------------------------------


def is_complete(path: str) -> bool:
    """True iff ``path`` is a checkpoint directory whose completion
    marker landed."""
    return os.path.isdir(path) and os.path.exists(os.path.join(path,
                                                               MANIFEST))


def _read_manifest(path: str) -> dict:
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path} is not a checkpoint directory (the reference's legacy "
            "single-file .npz format is not read by this package)")
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        raise FileNotFoundError(
            f"{path} has no {MANIFEST} — the save never completed "
            "(killed mid-write); restore from an earlier step")
    with open(mpath, encoding="utf-8") as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"{path}: checkpoint format "
                         f"{manifest.get('format')!r}, expected {_FORMAT}")
    return manifest


def read_metadata(path: str) -> dict:
    """The ``metadata`` dict a checkpoint was saved with (``step``, and —
    for Runtime checkpoints — the run config keys ``--resume`` validates
    before attempting a restore)."""
    return _read_manifest(path).get("metadata", {})


class _ShardFiles:
    """Lazily-opened npz handles for a checkpoint directory."""

    def __init__(self, path: str):
        self.path = path
        self._open: Dict[str, Any] = {}

    def __getitem__(self, fname: str):
        if fname not in self._open:
            self._open[fname] = np.load(os.path.join(self.path, fname),
                                        allow_pickle=False)
        return self._open[fname]

    def close(self):
        for f in self._open.values():
            f.close()
        self._open.clear()


def _leaf(key: str, entry: dict, files: _ShardFiles) -> np.ndarray:
    """A leaf saved whole, in one shard. A leaf split over several shards
    (the reference's checkpoints of a device mesh) needs the sharded
    restore, which is not here."""
    shards = entry["shards"]
    if len(shards) != 1 or shards[0]["index"] != [[0, d] for d in
                                                  entry["shape"]]:
        raise ValueError(
            f"checkpoint leaf {key!r} is saved in {len(shards)} shard(s) "
            "of a device mesh; this package restores only leaves saved "
            "whole")
    return np.asarray(files[shards[0]["file"]][shards[0]["key"]],
                      dtype=np.dtype(entry["dtype"]))


def _validate_tree(manifest: dict, template_keys: Sequence[str],
                   path: str) -> None:
    """Fail up front, naming mismatched keys, when the checkpoint was
    written by a different agent/config than the current run."""
    saved = set(manifest["tree"])
    want = set(template_keys)
    missing = sorted(want - saved)
    extra = sorted(saved - want)
    if missing or extra:
        def clip(keys):
            return ", ".join(keys[:6]) + (" …" if len(keys) > 6 else "")
        parts = [f"checkpoint {path} does not match this run's model/"
                 "config (wrong --agent / --env / optimizer?):"]
        if missing:
            parts.append(f" this run expects keys the checkpoint lacks: "
                         f"[{clip(missing)}]")
        if extra:
            parts.append(f" the checkpoint has keys this run lacks: "
                         f"[{clip(extra)}]")
        raise ValueError("".join(parts))


def restore(path: str, like):
    """Restore into the structure of ``like``; returns (tree, metadata).

    Each tensor leaf of ``like`` comes back as a tensor on that leaf's
    device (the saved dtype kept); any other leaf comes back as a numpy
    array. The checkpoint's keys are checked against the template's
    before any array is read."""
    manifest = _read_manifest(path)
    pairs = flatten(like)
    _validate_tree(manifest, [k for k, _ in pairs], path)
    files = _ShardFiles(path)
    try:
        leaves = []
        for key, leaf in pairs:
            entry = manifest["tree"][key]
            if hasattr(leaf, "shape") \
                    and tuple(entry["shape"]) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key}: {tuple(entry['shape'])} "
                    f"vs {tuple(leaf.shape)}")
            arr = _leaf(key, entry, files)
            leaves.append(torch.from_numpy(arr).to(leaf.device)
                          if isinstance(leaf, torch.Tensor) else arr)
    finally:
        files.close()
    return rebuild(like, iter(leaves)), manifest.get("metadata", {})


def load_flat(path: str):
    """(flat key -> numpy array, metadata) for every learner-tree leaf —
    the test/debug view of a checkpoint's contents."""
    manifest = _read_manifest(path)
    files = _ShardFiles(path)
    try:
        flat = {key: _leaf(key, entry, files)
                for key, entry in manifest["tree"].items()}
    finally:
        files.close()
    return flat, manifest.get("metadata", {})


def restore_structured(path: str, name: str):
    """Restore the self-describing tree saved via
    ``save(..., structured={name: tree})``: nested dicts, lists, tuples,
    scalars and numpy arrays. ``None`` when the name is absent, or when
    the checkpoint was written by several processes (source state is per
    process; the caller starts that piece fresh)."""
    manifest = _read_manifest(path)
    entry = manifest.get("structured", {}).get(name)
    if entry is None or manifest.get("num_processes", 1) != 1:
        return None
    mine = entry["0"]
    with np.load(os.path.join(path, mine["file"]),
                 allow_pickle=False) as data:
        return _decode(mine["schema"], data)


def latest_step_path(ckpt_dir: str):
    """The highest-step COMPLETE checkpoint under ``ckpt_dir`` — step
    directories without their completion marker (killed mid-write) are
    skipped, so a torn save can never shadow the last good step."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or not name[5:].isdigit():
            continue
        full = os.path.join(ckpt_dir, name)
        if is_complete(full):
            steps.append((int(name[5:]), full))
    return max(steps)[1] if steps else None
