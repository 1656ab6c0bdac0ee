"""The port's manifest checkpoints against the reference's format and
semantics: the structured layer round-trips, each package reads the
other's checkpoints (the on-disk format is shared), a torn write never
shadows the latest step, restore checks structure up front, the
background writer keeps order and surfaces failures, and the Runtime's
crash checkpoint keeps the original error and never saves a state torn
by a failure inside the learner step."""

import json
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as ckpt_lib
from repro_torch.tree import flatten
from repro_torch.checkpoint import AsyncCheckpointWriter, CheckpointWriteError
from repro_torch.configs.atari_impala import small_train
from repro_torch.core import learner as learner_lib
from repro_torch.core.runtime import Runtime
from repro_torch.core.sources import DeviceSource
from repro_torch.envs import catch
from repro_torch.models.convnet import minatar_net
from repro_torch.optim import make_optimizer

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

T, B = 3, 4


class _State(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor


def _learner_tree():
    gen = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(2, 3, generator=gen),
                       "b": torch.randn(3, generator=gen)},
            "opt_state": {"ms": [torch.rand(2, 3, generator=gen),
                                 torch.rand(3, generator=gen)]},
            "count": torch.tensor(7, dtype=torch.int32)}


def _equal_trees(a, b):
    """Leaf for leaf by path (the reference's trees sort dict keys)."""
    fa = dict(flatten(a))
    fb = dict(flatten(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# format and round trips


def test_structured_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(5)
    state = {
        "kind": "Thing",
        "none": None,
        "nested": {"tuple": (np.arange(6).reshape(2, 3), "s", 4.5),
                   "list": [True, np.float32(1.5), None]},
        "rng": rng.bit_generator.state,          # 128-bit ints survive JSON
        "generator": gen.get_state(),
        "carry": (_State(torch.arange(3), torch.ones(2, 2)),
                  torch.zeros(4, dtype=torch.bool)),
    }
    path = str(tmp_path / "step_7")
    ckpt_lib.save(path, {"x": torch.zeros(2)}, {"step": 7},
                  structured={"source": state})
    out = ckpt_lib.restore_structured(path, "source")
    assert out["kind"] == "Thing" and out["none"] is None
    tup = out["nested"]["tuple"]
    assert isinstance(tup, tuple) and tup[1] == "s" and tup[2] == 4.5
    np.testing.assert_array_equal(tup[0], np.arange(6).reshape(2, 3))
    assert out["nested"]["list"] == [True, 1.5, None]
    assert out["rng"] == rng.bit_generator.state
    restored_gen = torch.Generator()
    restored_gen.set_state(torch.from_numpy(out["generator"]))
    assert torch.equal(torch.rand(5, generator=restored_gen),
                       torch.rand(5, generator=gen))
    (x, y), done = out["carry"]              # the NamedTuple is a tuple now
    np.testing.assert_array_equal(x, np.arange(3))
    assert done.dtype == np.bool_ and not done.any()
    restored, meta = ckpt_lib.restore(path, {"x": torch.ones(2)})
    assert meta["step"] == 7 and torch.equal(restored["x"], torch.zeros(2))
    assert ckpt_lib.restore_structured(path, "absent") is None


def test_manifest_layout_and_restore_into_template(tmp_path):
    tree = _learner_tree()
    path = str(tmp_path / "step_1")
    ckpt_lib.save(path, tree, {"step": 1, "mode": "rl-agent"})
    names = sorted(os.listdir(path))
    assert names == ["manifest.json", "shard-00000.json", "shard-00000.npz"]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == 2 and manifest["num_processes"] == 1
    entry = manifest["tree"]["opt_state/ms/#0"]
    assert entry["shape"] == [2, 3] and entry["dtype"] == "float32"
    assert entry["shards"] == [{"key": "opt_state/ms/#0@0",
                                "index": [[0, 2], [0, 3]],
                                "file": "shard-00000.npz"}]
    assert ckpt_lib.read_metadata(path) == {"step": 1, "mode": "rl-agent"}
    template = {"params": {"w": torch.zeros(2, 3), "b": torch.zeros(3)},
                "opt_state": {"ms": [torch.zeros(2, 3), torch.zeros(3)]},
                "count": np.zeros((), np.int32)}
    restored, meta = ckpt_lib.restore(path, template)
    assert meta["step"] == 1
    assert isinstance(restored["opt_state"]["ms"], list)
    assert isinstance(restored["params"]["w"], torch.Tensor)
    assert isinstance(restored["count"], np.ndarray)
    _equal_trees(restored, tree)


def test_snapshot_copies_rather_than_views():
    """The learner updates its tensors in place after a snapshot is taken;
    the snapshot must keep the values of the moment it was taken."""
    tree = _learner_tree()
    snap = ckpt_lib.snapshot(tree, structured={"s": {"t": tree["params"]}})
    before = snap.leaves["params/w"].copy()
    with torch.no_grad():
        tree["params"]["w"].add_(1.0)
    np.testing.assert_array_equal(snap.leaves["params/w"], before)
    np.testing.assert_array_equal(snap.arrays["__structured__/s/t/w"],
                                  before)


def test_port_checkpoint_reads_under_the_reference(tmp_path):
    """A checkpoint the port wrote is complete, and its load_flat,
    read_metadata and restore_structured agree under repro.checkpoint."""
    tree = _learner_tree()
    structured = {"kind": "DeviceSource", "dispatches": 3,
                  "pending": {"obs": torch.rand(3, 2)},
                  "stream": {"carry": (_State(torch.arange(2),
                                              torch.ones(2)),),
                             "generator": torch.Generator().get_state()}}
    path = str(tmp_path / "step_4")
    ckpt_lib.save(path, tree, {"step": 4, "env": "catch"},
                  structured={"source": structured})
    assert jckpt.is_complete(path)
    assert jckpt.read_metadata(path) == ckpt_lib.read_metadata(path)
    assert jckpt.latest_step_path(str(tmp_path)) == path
    flat_j, meta_j = jckpt.load_flat(path)
    flat_t, meta_t = ckpt_lib.load_flat(path)
    assert meta_j == meta_t == {"step": 4, "env": "catch"}
    assert set(flat_j) == set(flat_t) == {
        "params/w", "params/b", "opt_state/ms/#0", "opt_state/ms/#1",
        "count"}
    for k in flat_t:
        np.testing.assert_array_equal(flat_j[k], flat_t[k], err_msg=k)
        assert flat_j[k].dtype == flat_t[k].dtype
    _equal_trees(jckpt.restore_structured(path, "source"),
                 ckpt_lib.restore_structured(path, "source"))
    # the reference restores the learner tree into its own template too
    restored, _ = jckpt.restore(path, {
        "params": {"w": jnp.zeros((2, 3)), "b": jnp.zeros(3)},
        "opt_state": {"ms": [jnp.zeros((2, 3)), jnp.zeros(3)]},
        "count": jnp.zeros((), jnp.int32)})
    _equal_trees(restored, tree)


def test_reference_checkpoint_reads_under_the_port(tmp_path):
    """The reverse: a checkpoint of numpy trees that repro.checkpoint
    wrote reads through every read API of the port."""
    rng = np.random.default_rng(0)
    tree = {"params": {"w": rng.normal(size=(2, 3)).astype(np.float32)},
            "opt_state": {"ms": [rng.random(3).astype(np.float32)]}}
    state = {"kind": "DeviceSource", "dispatches": 2,
             "stream": {"key": np.array([0, 42], np.uint32)},
             "rng": rng.bit_generator.state}
    path = str(tmp_path / "step_2")
    jckpt.save(path, tree, {"step": 2, "mode": "rl-agent"},
               structured={"source": state})
    assert ckpt_lib.is_complete(path)
    assert ckpt_lib.latest_step_path(str(tmp_path)) == path
    assert ckpt_lib.read_metadata(path) == {"step": 2, "mode": "rl-agent"}
    flat, _ = ckpt_lib.load_flat(path)
    assert set(flat) == {"params/w", "opt_state/ms/#0"}
    np.testing.assert_array_equal(flat["params/w"], tree["params"]["w"])
    _equal_trees(ckpt_lib.restore_structured(path, "source"),
                 jckpt.restore_structured(path, "source"))
    restored, meta = ckpt_lib.restore(path, {
        "params": {"w": torch.zeros(2, 3)},
        "opt_state": {"ms": [torch.zeros(3)]}})
    assert meta["step"] == 2
    _equal_trees(restored, tree)


def test_torn_write_never_shadows_latest(tmp_path):
    tree = {"w": torch.arange(4.0)}
    good = str(tmp_path / "step_2")
    ckpt_lib.save(good, tree, {"step": 2})
    # a kill mid-save of step 4: shard files landed, the manifest
    # (completion marker) did not
    torn = str(tmp_path / "step_4")
    ckpt_lib.save(torn, tree, {"step": 4})
    os.remove(os.path.join(torn, ckpt_lib.MANIFEST))
    # a file that is no checkpoint directory (the reference's legacy
    # single-file format, which this package does not read)
    (tmp_path / "step_9.npz").write_bytes(b"")
    assert not ckpt_lib.is_complete(torn)
    assert ckpt_lib.is_complete(good)
    assert ckpt_lib.latest_step_path(str(tmp_path)) == good
    with pytest.raises(FileNotFoundError, match="never completed"):
        ckpt_lib.restore(torn, tree)
    with pytest.raises(FileNotFoundError, match="legacy"):
        ckpt_lib.load_flat(str(tmp_path / "step_9.npz"))
    assert ckpt_lib.latest_step_path(str(tmp_path / "absent")) is None


def test_leaf_saved_in_shards_is_refused(tmp_path):
    """A leaf saved in several shards (a device mesh's slices) is
    assembled from them; one whose shards do not cover it (a shard
    missing) is refused by every reader instead of returned in part."""
    path = str(tmp_path / "step_1")
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ckpt_lib.save(path, {"w": w}, {"step": 1})
    np.savez(os.path.join(path, "shard-00000.npz"),
             **{"w@0": w[:1].numpy(), "w@1": w[1:].numpy()})
    mpath = os.path.join(path, ckpt_lib.MANIFEST)
    with open(mpath) as f:
        manifest = json.load(f)
    whole = manifest["tree"]["w"]["shards"][0]
    manifest["tree"]["w"]["shards"] = [
        dict(whole, index=[[0, 1], [0, 3]]),
        dict(whole, key="w@1", index=[[1, 2], [0, 3]])]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    assert torch.equal(ckpt_lib.restore(path, {"w": torch.zeros(2, 3)})[0]
                       ["w"], w)
    assert np.array_equal(ckpt_lib.load_flat(path)[0]["w"], w.numpy())
    manifest["tree"]["w"]["shards"].pop()
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    for read in (lambda: ckpt_lib.load_flat(path),
                 lambda: ckpt_lib.restore(path, {"w": torch.zeros(2, 3)})):
        with pytest.raises(ValueError, match="cover 3/6"):
            read()


def test_restore_validates_structure_up_front(tmp_path):
    path = str(tmp_path / "step_1")
    ckpt_lib.save(path, {"params": {"w": torch.zeros(2),
                                    "b": torch.zeros(3)}})
    template = {"params": {"w": torch.zeros(2), "scale": torch.zeros(3)}}
    with pytest.raises(ValueError) as err:
        ckpt_lib.restore(path, template)
    msg = str(err.value)
    # the aggregate diff names BOTH directions of the mismatch
    assert "params/scale" in msg and "params/b" in msg
    with pytest.raises(ValueError, match="shape mismatch for params/b"):
        ckpt_lib.restore(path, {"params": {"w": torch.zeros(2),
                                           "b": torch.zeros(4)}})


# ---------------------------------------------------------------------------
# background writer


def test_async_writer_writes_in_order_and_joins(tmp_path):
    lines = []
    w = AsyncCheckpointWriter(print_fn=lines.append)
    snap = ckpt_lib.snapshot({"x": torch.arange(3.0)})
    w.submit(str(tmp_path / "step_1"), snap, {"step": 1})
    w.submit(str(tmp_path / "step_2"), snap, {"step": 2})
    w.flush()
    w.close()
    assert ckpt_lib.is_complete(str(tmp_path / "step_1"))
    assert ckpt_lib.is_complete(str(tmp_path / "step_2"))
    saved = [ln for ln in lines if ln.startswith("saved ")]
    assert saved == [f"saved {tmp_path}/step_1", f"saved {tmp_path}/step_2"]
    assert not w._thread  # joined — no writer thread outlives its run


def test_async_writer_failure_surfaces_on_flush(tmp_path):
    lines = []
    w = AsyncCheckpointWriter(print_fn=lines.append)
    snap = ckpt_lib.snapshot({"x": torch.zeros(2)})
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("occupied")
    w.submit(str(blocker / "step_1"), snap)
    with pytest.raises(CheckpointWriteError):
        w.flush()
    w.close(raise_on_error=False)
    assert any("checkpoint write failed" in ln for ln in lines)


# ---------------------------------------------------------------------------
# the Runtime's crash checkpoint


def _runtime_parts(total_steps, seed=1):
    env = catch.make()
    agent = minatar_net(env.obs_shape, env.num_actions,
                        generator=torch.Generator().manual_seed(0))
    cfg = small_train(unroll_length=T, batch_size=B,
                      total_steps=total_steps)
    opt = make_optimizer(cfg)
    src = DeviceSource.for_env(env, agent, unroll_length=T, batch_size=B,
                               seed=seed, pipelined=False)
    return (src, learner_lib.make_train_step(opt, cfg), agent,
            opt.init(list(agent.parameters())))


def test_crash_checkpoint_failure_preserves_original_error(
        tmp_path, monkeypatch):
    """When the crash-path save itself dies, the ORIGINAL training failure
    must reach the caller — the save failure is logged, not raised."""
    src, step, agent, opt_state = _runtime_parts(6)

    def no_disk(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_lib, "snapshot", no_disk)

    def boom(s, m):
        if s == 1:
            raise RuntimeError("the original failure")

    lines = []
    rt = Runtime(src, step, agent, opt_state, total_steps=6, log_every=0,
                 checkpoint_dir=str(tmp_path), on_metrics=boom,
                 print_fn=lines.append)
    with pytest.raises(RuntimeError, match="the original failure"):
        rt.run()
    assert any("crash checkpoint failed" in ln and "disk full" in ln
               for ln in lines)


def test_crash_inside_step_fn_writes_no_torn_state(tmp_path):
    """The port's learner updates params and optimizer state in place, so
    a failure inside step_fn may leave them half-updated. The Runtime
    must not save that state under any step's name: the periodic
    checkpoint stays the latest, and the skip is printed with its
    reason."""
    src, step, agent, opt_state = _runtime_parts(8)
    calls = {"n": 0}

    def tearing_step(p, o, s, batch):
        if calls["n"] == 3:
            with torch.no_grad():               # half an update, then die
                next(p.parameters()).add_(1.0)
            raise RuntimeError("learner died mid-update")
        calls["n"] += 1
        return step(p, o, s, batch)

    lines = []
    rt = Runtime(src, tearing_step, agent, opt_state, total_steps=8,
                 log_every=0, checkpoint_dir=str(tmp_path),
                 checkpoint_every=2, print_fn=lines.append)
    with pytest.raises(RuntimeError, match="mid-update"):
        rt.run()
    assert sorted(os.listdir(tmp_path)) == ["step_2"]
    assert ckpt_lib.latest_step_path(str(tmp_path)).endswith("step_2")
    assert any("crash checkpoint skipped" in ln and "torn" in ln
               for ln in lines)
