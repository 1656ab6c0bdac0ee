"""Manifest checkpoints, single process or one file pair per rank.

A checkpoint is a DIRECTORY, in the same on-disk format as the reference
package's (``_FORMAT`` 2), so each package reads the other's:

    step_40/
      shard-00000.npz    process 0's arrays: its slice of every learner-tree
                         leaf it writes, and its structured (source) state
      shard-00000.json   sidecar: global shape/dtype/spec per leaf and the
                         global index of each slice, structured schema,
                         metadata
      shard-00001.*      process 1's, ... (a model-parallel run)
      manifest.json      written LAST by process 0 — the COMPLETION MARKER

A model-parallel run (``--mesh-model``: a ``launch/mesh.py::Mesh2D``)
writes one pair per rank, as the reference's processes do: each unique
slice once (model rank r of data index 0 writes slice r of a split leaf;
a whole leaf is written by process 0 only), every rank its own
structured state. Once the pairs have landed (a barrier on the mesh's
rendezvous store, off the learner's collectives, as the reference waits
on its coordination service), process 0 merges the sidecars into the
manifest. ``restore(..., shardings=)`` assembles each block a rank asks
for from whichever saved slices overlap it, so a checkpoint restores onto
any mesh shape (elastic resume).

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

Not here: the reader of the reference's legacy single-file
``step_N.npz`` (a format this package never wrote).
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
# a mesh's saves so far, by (its mesh_id, path): every rank of the mesh
# saves the same paths in the same order, so each barrier's name agrees
_SAVES: Dict[Tuple[str, str], int] = {}


def _shard_npz(pid: int) -> str:
    return f"shard-{pid:05d}.npz"


def _shard_json(pid: int) -> str:
    return f"shard-{pid:05d}.json"


def _full_index(shape) -> List[List[int]]:
    return [[0, d] for d in shape]


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
    a background writer while training mutates the live tensors.

    ``layout``: for a rank of a mesh, key -> {"shape": the whole leaf's,
    "index": the global index of ``leaves[key]``, "spec": the reference's
    partition spec, "write": whether this process writes it}; a key it
    does not name is a whole leaf, written. ``mesh``: the ``Mesh2D`` the
    snapshot was taken on (None: one process)."""
    leaves: Dict[str, np.ndarray]
    structured: Dict[str, dict] = field(default_factory=dict)   # schemas
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)  # npz extras
    layout: Dict[str, dict] = field(default_factory=dict)
    mesh: Any = None


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
    process's shard arrays and sidecar, then (process 0, after every
    process's pair has landed) the ``manifest.json`` completion marker.
    Under a mesh every rank must call this with the same ``path``."""
    mesh = snap.mesh
    pid, nproc = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    os.makedirs(path, exist_ok=True)
    arrays = dict(snap.arrays)
    tree_entries: Dict[str, dict] = {}
    for key, arr in snap.leaves.items():
        lay = snap.layout.get(key, {})
        shards = []
        if lay.get("write", True):
            arrays[f"{key}@0"] = arr
            shards.append({"key": f"{key}@0",
                           "index": lay.get("index", _full_index(arr.shape))})
        tree_entries[key] = {"shape": list(lay.get("shape", arr.shape)),
                             "dtype": str(arr.dtype),
                             "spec": lay.get("spec"), "shards": shards}
    _atomic_write(os.path.join(path, _shard_npz(pid)),
                  lambda f: np.savez(f, **arrays))
    sidecar = {"process": pid, "tree": tree_entries,
               "structured": snap.structured,
               "mesh": None if mesh is None else dict(mesh.shape),
               "metadata": metadata or {}}
    _atomic_write(os.path.join(path, _shard_json(pid)),
                  lambda f: f.write(json.dumps(sidecar).encode()))
    # every process's pair is on disk before the manifest names it
    name = None
    if mesh is not None:
        key = (mesh.mesh_id, os.path.normpath(path))
        _SAVES[key] = _SAVES.get(key, -1) + 1
        name = f"ckpt:{key[0]}:{key[1]}:{_SAVES[key]}"
    _barrier(mesh, f"{name}:shards")
    if pid == 0:
        _atomic_write(os.path.join(path, MANIFEST),
                      lambda f: f.write(json.dumps(
                          _merge_manifest(path, nproc)).encode()))
    _barrier(mesh, f"{name}:done")


def _barrier(mesh, name: str) -> None:
    """A barrier of the mesh's processes on its rendezvous store (no
    collective: the writer thread runs beside the learner's); a no-op for
    one process."""
    if mesh is None or mesh.size == 1:
        return
    from repro_torch.launch.mesh import store_barrier
    store_barrier(mesh, name)


def _merge_manifest(path: str, nproc: int) -> dict:
    """The manifest of ``nproc`` processes' sidecars: each leaf's shape,
    dtype and spec, and every process's slices of it with their file."""
    tree: Dict[str, dict] = {}
    structured: Dict[str, dict] = {}
    metadata: dict = {}
    mesh = None
    for pid in range(nproc):
        with open(os.path.join(path, _shard_json(pid)),
                  encoding="utf-8") as f:
            sc = json.load(f)
        fname = _shard_npz(pid)
        for key, entry in sc["tree"].items():
            tgt = tree.setdefault(key, {"shape": entry["shape"],
                                        "dtype": entry["dtype"],
                                        "spec": entry["spec"],
                                        "shards": []})
            tgt["shards"].extend(dict(s, file=fname)
                                 for s in entry["shards"])
        for name, schema in sc["structured"].items():
            structured.setdefault(name, {})[str(pid)] = {
                "file": fname, "schema": schema}
        if pid == 0:
            metadata = sc["metadata"]
            mesh = sc.get("mesh")
    return {"format": _FORMAT, "num_processes": nproc,
            "metadata": metadata, "mesh": mesh,
            "tree": tree, "structured": structured}


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


def _assemble(key: str, entry: dict, files: _ShardFiles,
              target: Sequence[Sequence[int]]) -> np.ndarray:
    """The ``target`` block (a global index) of a leaf, from whichever
    saved slices overlap it — the elastic core: the block may cut across
    the saved slices' boundaries anywhere."""
    tgt_shape = tuple(b - a for a, b in target)
    out = np.empty(tgt_shape, dtype=np.dtype(entry["dtype"]))
    covered = 0
    for shard in entry["shards"]:
        dst, src = [], []
        vol = 1
        for (t0, t1), (s0, s1) in zip(target, shard["index"]):
            lo, hi = max(t0, s0), min(t1, s1)
            if lo >= hi:
                vol = 0
                break
            dst.append(slice(lo - t0, hi - t0))
            src.append(slice(lo - s0, hi - s0))
            vol *= hi - lo
        if vol == 0:
            continue
        data = files[shard["file"]][shard["key"]]
        out[tuple(dst)] = data[tuple(src)]    # 0-d: out[()] = data[()]
        covered += vol
    want = int(np.prod(tgt_shape, dtype=np.int64)) if tgt_shape else 1
    if covered != want:
        raise ValueError(
            f"checkpoint slices of {key!r} cover {covered}/{want} elements "
            f"of index {[list(t) for t in target]} — shard files are "
            "missing or the save was interrupted")
    return out


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


def restore(path: str, like, shardings=None):
    """Restore into the structure of ``like``; returns (tree, metadata).

    Each tensor leaf of ``like`` comes back as a tensor on that leaf's
    device (the saved dtype kept); any other leaf comes back as a numpy
    array. The checkpoint's keys are checked against the template's
    before any array is read.

    ``shardings``: optional flat key -> (the whole leaf's shape, the
    global index of the block to restore), for a rank of a mesh: the leaf
    comes back as that block, assembled from whichever saved slices
    overlap it, on whatever mesh the checkpoint was written (elastic
    resume). A key it does not name comes back whole."""
    manifest = _read_manifest(path)
    pairs = flatten(like)
    _validate_tree(manifest, [k for k, _ in pairs], path)
    shardings = shardings or {}
    files = _ShardFiles(path)
    try:
        leaves = []
        for key, leaf in pairs:
            entry = manifest["tree"][key]
            shape, index = shardings.get(
                key, (entry["shape"], _full_index(entry["shape"])))
            if tuple(entry["shape"]) != tuple(shape):
                raise ValueError(
                    f"shape mismatch for {key}: {tuple(entry['shape'])} "
                    f"vs {tuple(shape)}")
            block = tuple(b - a for a, b in index)
            if hasattr(leaf, "shape") and block != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key}: block {block} vs "
                    f"{tuple(leaf.shape)}")
            arr = _assemble(key, entry, files, index)
            leaves.append(torch.from_numpy(arr).to(leaf.device)
                          if isinstance(leaf, torch.Tensor) else arr)
    finally:
        files.close()
    return rebuild(like, iter(leaves)), manifest.get("metadata", {})


def saved_shardings(path: str, mesh):
    """Flat key -> the partition spec each leaf was saved with (a tuple,
    or None for a leaf saved whole), when the checkpoint was written on a
    mesh of ``mesh``'s shape; None when it was not (another mesh shape or
    one process: an elastic resume, whose blocks the live mesh decides)."""
    manifest = _read_manifest(path)
    if mesh is None or manifest.get("mesh") != dict(mesh.shape):
        return None
    return {key: None if entry.get("spec") is None else tuple(
        tuple(p) if isinstance(p, list) else p for p in entry["spec"])
        for key, entry in manifest["tree"].items()}


def load_flat(path: str):
    """(flat key -> numpy array, metadata) for every learner-tree leaf —
    the test/debug view of a checkpoint's contents."""
    manifest = _read_manifest(path)
    files = _ShardFiles(path)
    try:
        flat = {key: _assemble(key, entry, files,
                               _full_index(entry["shape"]))
                for key, entry in manifest["tree"].items()}
    finally:
        files.close()
    return flat, manifest.get("metadata", {})


def restore_structured(path: str, name: str, process: int = 0,
                       num_processes: int = 1):
    """Restore process ``process``'s self-describing tree saved via
    ``save(..., structured={name: tree})``: nested dicts, lists, tuples,
    scalars and numpy arrays. ``None`` when the name is absent, or when
    the checkpoint was written by another number of processes than
    ``num_processes`` (source state is per process; the caller starts
    that piece fresh, while the learner state restores elastically)."""
    manifest = _read_manifest(path)
    entry = manifest.get("structured", {}).get(name)
    if entry is None or manifest.get("num_processes", 1) != num_processes:
        return None
    mine = entry.get(str(process))
    if mine is None:
        return None
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
