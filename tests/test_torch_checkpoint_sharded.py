"""Sharded, elastic LM checkpoints (``--mesh-model``) against the
reference's (``tests/test_checkpoint_sharded.py``, ``tests/test_mesh2d.py``):

* A ``--mode lm --mesh-model 2`` run writes one shard pair per rank whose
  merged manifest has the reference's keys, shapes, dtypes, specs, mesh
  and slice indices (the reference, one process over 2 forced devices,
  writes the same slices into one pair).
* A step directory without its manifest never shadows the latest.
* The port restores the reference's ``--mesh-model 2`` checkpoint at
  (1, 2) and at (1, 1), bitwise, through ``--resume``'s restore.
* The reference's ``restore(..., shardings=)`` reads the port's
  two-process checkpoint bitwise.
* Elastic: (1, 2) -> (2, 1) -> (1, 1), every leaf bitwise at each, the
  next step's loss within 1e-5 of the (1, 2) one's.

The kill-and-resume runs are in ``test_torch_lm_mesh_resume.py``.

This module's top level imports no JAX: spawned ranks import it to find
their worker functions.
"""

import argparse
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import get_reduced_config
from repro_torch.core import learner
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models import model as model_lib
from repro_torch.optim import make_optimizer
from repro_torch.tree import flatten

torch.set_num_threads(1)

ARCH = "qwen3-4b"
RULES = sharding.MEGATRON_RULES
LM_FLAGS = ["--mode", "lm", "--arch", ARCH, "--reduced", "--batch", "8",
            "--seq", "32"]


def _port_cmd(ckpt_dir, steps, extra=()):
    return ["-m", "repro_torch.launch.train", *LM_FLAGS, "--steps",
            str(steps), "--mesh-model", "2", "--device", "cpu",
            "--checkpoint-dir", ckpt_dir, *extra]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(the reference's step_2, the port's step_2): 2 steps of --mode lm
    --mesh-model 2 each."""
    from conftest import run_forced
    root = tmp_path_factory.mktemp("ckpts")
    ref, port = str(root / "ref"), str(root / "port")
    run_forced(["-m", "repro.launch.train", *LM_FLAGS, "--steps", "2",
                "--mesh-model", "2", "--checkpoint-dir", ref], devices=2,
               timeout=300)
    run_forced(_port_cmd(port, 2), devices=1, timeout=300)
    return os.path.join(ref, "step_2"), os.path.join(port, "step_2")


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_files_and_manifest_match_reference_layout(checkpoints):
    ref, port = checkpoints
    assert sorted(os.listdir(port)) == [
        "manifest.json", "shard-00000.json", "shard-00000.npz",
        "shard-00001.json", "shard-00001.npz"]
    want, got = _manifest(ref), _manifest(port)
    assert got["format"] == want["format"] == 2
    assert got["mesh"] == want["mesh"] == {"data": 1, "model": 2}
    assert got["num_processes"] == 2 and want["num_processes"] == 1
    assert set(got["tree"]) == set(want["tree"])
    split = 0
    for key, w in want["tree"].items():
        g = got["tree"][key]
        assert (g["shape"], g["dtype"], g["spec"]) == (
            w["shape"], w["dtype"], w["spec"]), key
        assert sorted(s["index"] for s in g["shards"]) == sorted(
            s["index"] for s in w["shards"]), key
        split += len(g["shards"]) == 2
        # each unique slice once: a split leaf's from each model rank, a
        # whole one from process 0
        assert sorted(s["file"] for s in g["shards"]) == (
            ["shard-00000.npz", "shard-00001.npz"] if len(g["shards"]) == 2
            else ["shard-00000.npz"]), key
    assert split
    assert sorted(got["structured"]["source"]) == ["0", "1"]
    assert got["metadata"]["step"] == 2
    # the saved specs, for a resume on a mesh of the same shape only
    mesh12 = mesh_lib.Mesh2D(0, 1, 2, torch.device("cpu"), "gloo")
    specs = ckpt_lib.saved_shardings(port, mesh12)
    assert specs["params/embed"] == ("model",)
    assert specs == {k: tuple(tuple(p) if isinstance(p, list) else p
                              for p in w["spec"])
                     for k, w in want["tree"].items()}
    assert ckpt_lib.saved_shardings(
        port, mesh_lib.Mesh2D(0, 2, 1, torch.device("cpu"), "gloo")) is None


def test_incomplete_step_never_shadows_latest(checkpoints, tmp_path):
    _, port = checkpoints
    d = tmp_path / "run"
    shutil.copytree(port, d / "step_2")
    torn = d / "step_9"
    torn.mkdir()
    for name in ("shard-00000.npz", "shard-00000.json"):
        shutil.copy(os.path.join(port, name), torn / name)
    assert not ckpt_lib.is_complete(str(torn))
    assert ckpt_lib.latest_step_path(str(d)) == str(d / "step_2")


# ---------------------------------------------------------------------------
# restores through --resume's path


def _args(ckpt_dir):
    return argparse.Namespace(checkpoint_dir=ckpt_dir, mode="lm", arch=ARCH)


def _built(mesh):
    """What build_lm holds on this rank: the tree (cut to the mesh's
    slices), its AdamW state, the layout, the data source."""
    from repro_torch.data import PackedBatchIterator, markov_corpus
    cfg = get_reduced_config(ARCH)
    params = model_lib.init(cfg, seed=3)            # overwritten by restore
    if mesh is not None:
        model_lib.shard_model(params, cfg, mesh, RULES)
    opt = make_optimizer(train.TrainConfig(optimizer="adamw",
                                           learning_rate=3e-4,
                                           grad_clip=1.0, total_steps=4))
    opt_state = opt.init(list(params.parameters()))
    it = PackedBatchIterator(markov_corpus(cfg.vocab_size, 20_000, seed=1),
                             8, 32, seed=0)
    source = train.sources_lib.DataSource(
        it, frames_per_batch=256, device="cpu", mesh=mesh,
        rules=None if mesh is None else RULES)
    return cfg, params, opt, opt_state, train._lm_layout(params, mesh), source


def _state(params, opt_state, layout):
    """This rank's learner state under the checkpoint's keys."""
    flat = dict(flatten({"params": params.state_dict(),
                         "opt_state": opt_state}))
    return {k: v.detach().clone() for k, v in flat.items()}, layout


def _expected_block(flat, key, layout, mesh, name):
    """The block of ``flat`` (whole leaves under the reference's keys)
    that this rank holds for port key ``key``."""
    where, group = layout._where(key)
    arr = flat[where] if group is None else flat[where][group]
    if mesh is None:
        return arr
    _, dim, _ = layout.model_layout[name]
    if dim is None:
        return arr
    n = arr.shape[dim] // mesh.model
    return np.take(arr, range(mesh.model_index * n,
                              (mesh.model_index + 1) * n), axis=dim)


def _check_blocks(params, opt_state, layout, flat, mesh):
    names = layout.names
    for key, v in flatten({"params": params.state_dict(),
                           "opt_state": opt_state}):
        name = key.partition("/")[2] if key.startswith("params/") \
            else names[int(key.rsplit("#", 1)[1])]
        want = _expected_block(flat, key, layout, mesh, name)
        assert np.array_equal(v.detach().numpy(), want), key


def _restore_rank(mesh, ckpt_dir, flat):
    cfg, params, opt, opt_state, layout, source = _built(mesh)
    opt_state, step = train._resume(_args(ckpt_dir), source, params,
                                    opt_state, layout, lambda line: None,
                                    mesh)
    _check_blocks(params, opt_state, layout, flat, mesh)
    return step


@pytest.mark.parametrize("model", [2, 1])
def test_port_restores_reference_checkpoint(checkpoints, model, tmp_path):
    from repro.checkpoint import load_flat as jload_flat
    ref, _ = checkpoints
    shutil.copytree(ref, tmp_path / "step_2")
    flat, _ = jload_flat(ref)
    if model == 1:
        assert _restore_rank(None, str(tmp_path), flat) == 2
        return
    from conftest import free_port
    assert mesh_lib.launch(_restore_rank, 2, device="cpu", model=2,
                           args=(str(tmp_path), flat), port=free_port(),
                           timeout_s=60) == 2


_REF_RESTORE = r"""
import sys
import jax
import numpy as np
from repro import checkpoint as ckpt_lib
from repro.configs import get_reduced_config
from repro.configs.base import TrainConfig
from repro.distributed import sharding as shd
from repro.launch.mesh import make_mesh2d
from repro.models import model as M
from repro.optim import make_optimizer

path = sys.argv[1]
cfg = get_reduced_config("qwen3-4b")
params, axes = M.init(jax.random.PRNGKey(5), cfg)
opt = make_optimizer(TrainConfig(optimizer="adamw", learning_rate=3e-4,
                                 grad_clip=1.0, total_steps=4))
mesh = make_mesh2d(1, 2)
pshard = shd.param_shardings(axes, mesh, shd.MEGATRON_RULES, params)
params = jax.device_put(params, pshard)
opt_state = opt.init(params)
like = {"params": params, "opt_state": opt_state}
restored, meta = ckpt_lib.restore(path, like,
                                  shardings=shd.tree_shardings(like))
flat, _ = ckpt_lib.load_flat(path)
leaves = jax.tree_util.tree_flatten_with_path(restored)[0]
split = 0
for keys, leaf in leaves:
    key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                   for k in keys)
    assert np.array_equal(np.asarray(leaf), flat[key]), key
    split += any(s.data.shape != leaf.shape for s in leaf.addressable_shards)
np.savez(sys.argv[2], **{"/".join(str(getattr(k, "key", k)) for k in p):
                         np.asarray(v) for p, v in leaves})
print("REF RESTORE OK", meta["step"], split)
"""


def test_reference_restores_port_checkpoint(checkpoints, tmp_path):
    from conftest import run_forced
    _, port = checkpoints
    out = tmp_path / "restored.npz"
    proc = run_forced(["-c", _REF_RESTORE, port, str(out)], devices=2,
                      timeout=300)
    line = [ln for ln in proc.stdout.splitlines() if "REF RESTORE OK" in ln]
    assert line and int(line[0].split()[-1]) > 0, proc.stdout
    # bitwise what the port wrote, as the port itself reads it
    flat, _ = ckpt_lib.load_flat(port)
    with np.load(out) as got:
        assert set(got.files) == set(flat)
        for k in flat:
            assert np.array_equal(got[k], flat[k]), k


# ---------------------------------------------------------------------------
# elastic (1, 2) -> (2, 1) -> (1, 1)


def _one_step(cfg, params, opt, opt_state, mesh, batch):
    step = learner.make_lm_pretrain_step(
        cfg, opt, loss_chunk=32, mesh=mesh,
        rules=None if mesh is None else RULES)
    if mesh is not None:
        batch = sharding.shard_lm_batch(batch, mesh, RULES)
    _, _, m = step(params, opt_state, 2, batch)
    return float(m["loss"])


def _elastic_rank(mesh, ckpt_dir, out_dir, flat, batch):
    """Restore, check every block, write this mesh's checkpoint of the
    restored state to ``out_dir``, then one step's loss."""
    cfg, params, opt, opt_state, layout, source = _built(mesh)
    opt_state, _ = train._resume(_args(ckpt_dir), source, params, opt_state,
                                 layout, lambda line: None, mesh)
    _check_blocks(params, opt_state, layout, flat, mesh)
    if out_dir is not None:
        snap = ckpt_lib.snapshot({"params": params.state_dict(),
                                  "opt_state": opt_state},
                                 structured={"source": source.state_dict()})
        if mesh is not None:
            snap.layout = layout.disk_layout(list(snap.leaves))
            snap.mesh = mesh
        snap.leaves = layout.to_disk(snap.leaves)
        ckpt_lib.write_snapshot(os.path.join(out_dir, "step_2"), snap,
                                {"step": 2, "mode": "lm", "arch": ARCH})
    loss = _one_step(cfg, params, opt, opt_state, mesh, batch)
    return loss if mesh is None else sharding.gather_to_main(loss, mesh)


def test_elastic_restore_across_mesh_shapes(checkpoints, tmp_path):
    from conftest import free_port
    _, port = checkpoints
    flat, _ = ckpt_lib.load_flat(port)
    src = tmp_path / "m12"
    shutil.copytree(port, src / "step_2")
    tokens = np.random.default_rng(4).integers(0, 512, (8, 33))
    batch = {"tokens": torch.from_numpy(tokens)}
    losses = {}
    for (data, model), ckpt, out in (
            ((1, 2), src, None), ((2, 1), src, tmp_path / "m21")):
        losses[data, model] = mesh_lib.launch(
            _elastic_rank, 2, device="cpu", model=model,
            args=(str(ckpt), None if out is None else str(out), flat, batch),
            port=free_port(), timeout_s=60)
    # the (2, 1) checkpoint, read back at (1, 1)
    assert _manifest(tmp_path / "m21" / "step_2")["mesh"] == {
        "data": 2, "model": 1}
    losses[1, 1] = _elastic_rank(None, str(tmp_path / "m21"), None, flat,
                                 batch)
    base = losses[1, 2][0]
    for key, got in losses.items():
        for loss in (got if isinstance(got, list) else [got]):
            assert abs(loss - base) <= 1e-5 * max(1.0, abs(base)), (key,
                                                                     loss)
