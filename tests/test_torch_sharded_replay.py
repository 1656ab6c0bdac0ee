"""Sharded replay and the data-parallel CLI (``--mesh-data``) against the
reference's ``ShardedReplay`` contract (``tests/test_sharded.py``'s
parity script): Catch, the minatar agent, T 10, B 8.

* Two gloo ranks: each rank's mixed batch is its block of the reference's
  per-device interleaved layout, ``is_replay`` the matching slice of
  ``np.tile([False] * b + [True] * k, N)``, the learner's priorities
  reach ``(rank, ticket)`` slots, the gauges are global; at world size 1
  the sharded replay is bitwise the single-device one, and so is
  ``--mesh-data 1 --replay elite`` through the entry point.
* Divisibility is enforced with the reference's words.
* The CLI: ``--mesh-data 2`` x ``--replay {off, elite, uniform}`` x
  ``--actors {device, host}`` all run; ``--mesh-data 2`` checkpointed at
  step 3 and resumed to 6 is bitwise the uninterrupted run, with and
  without ``--replay elite``; another world size refuses the checkpoint.

Every multi-process case takes its port from ``conftest.free_port`` and
bounds every wait at ``JOIN_S``. The top level imports no JAX: spawned
ranks import this module to find their worker functions.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.core.replay import ShardedReplay, make_buffer
from repro_torch.core.sources import (DeviceSource, ReplaySource,
                                      ShardedDeviceSource, check_rollout)
from repro_torch.distributed import sharding
from repro_torch.envs import catch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models.convnet import minatar_net

torch.set_num_threads(1)

T, B = 10, 8
JOIN_S = 60.0     # every rendezvous, collective and join of a test


def _port():
    from conftest import free_port
    return free_port()


def _agent():
    env = catch.make()
    return env, minatar_net(env.obs_shape, env.num_actions,
                            generator=torch.Generator().manual_seed(0))


def _replay_rank(mesh):
    """Three mixed batches and their feedback on this rank; returns, on
    rank 0, every rank's masks, slot ids, partition priorities and the
    global gauges."""
    env, agent = _agent()
    src = ReplaySource(
        ShardedDeviceSource.for_env(env, agent, unroll_length=T,
                                    batch_size=B, seed=2, mesh=mesh),
        ShardedReplay("elite", 32, mesh), replay_ratio=1.0)
    b = B // mesh.size
    masks, ids = [], []
    for i in range(3):
        mixed = src.next_batch(agent)
        check_rollout(mixed, T, 2 * b)
        masks.append(mixed["is_replay"].tolist())
        ids.append(list(src._last_ids))
        src.on_learner_metrics(i, {"priority": torch.arange(
            2 * b, dtype=torch.float64) + 100 * mesh.rank + 10 * i})
    part = src.buffer._part
    prios = sorted(part._prio[part._live].tolist())
    stats = src.stats()
    src.stop()
    return sharding.gather_to_main((masks, ids, prios, stats), mesh)


def test_sharded_replay_layout_priorities_and_gauges():
    n = 2
    per_rank = mesh_lib.launch(_replay_rank, n, device="cpu", port=_port(),
                               timeout_s=JOIN_S)
    b = k = B // n
    ref_mask = np.tile([False] * b + [True] * k, n)   # the reference's
    for rank, (masks, ids, prios, stats) in enumerate(per_rank):
        for mask, slot_ids in zip(masks, ids):
            np.testing.assert_array_equal(
                mask, ref_mask[rank * (b + k):(rank + 1) * (b + k)])
            assert len(slot_ids) == b + k
            assert all(d == rank for d, _ in slot_ids)
        # every live priority is feedback this rank sent (100 * rank +
        # 10 * step + column), the last fresh block's exactly
        assert all(100 * rank <= p < 100 * rank + 30 for p in prios)
        assert {100.0 * rank + 20 + c for c in range(b)} <= set(prios)
        assert stats == per_rank[0][3]          # one global figure
    stats = per_rank[0][3]
    assert stats["replay_inserted"] == 3 * B
    assert stats["replay_occupancy"] == 3 * B / 32
    assert stats["replay_hit_rate"] == pytest.approx(2 / 3)


def test_sharded_replay_world1_bitwise_single_buffer():
    env, agent = _agent()

    def run(mesh):
        kw = dict(unroll_length=T, batch_size=B, seed=4)
        if mesh is None:
            src = ReplaySource(DeviceSource.for_env(env, agent, **kw),
                               make_buffer("elite", 32), seed=7)
        else:
            src = ReplaySource(
                ShardedDeviceSource.for_env(env, agent, mesh=mesh, **kw),
                ShardedReplay("elite", 32, mesh), seed=7)
        out = []
        for i in range(4):
            out.append(src.next_batch(agent))
            src.on_learner_metrics(i, {"priority": torch.linspace(
                0.1, 2.0, 2 * B) * (i + 1)})
        state = src.state_dict()
        src.stop()
        return out, state

    plain, plain_state = run(None)
    with mesh_lib.make_data_mesh(1, "cpu", port=_port(),
                                 timeout_s=JOIN_S) as mesh:
        sharded, state = run(mesh)
    for a, b in zip(plain, sharded):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert state["buffer"]["kind"] == "ShardedReplay"
    assert state["buffer"]["n"] == 1
    _same_tree(state["buffer"]["parts"][0], plain_state["buffer"])
    assert state["last_ids"] == [(0, t) for t in plain_state["last_ids"]]
    assert state["rng"] == [plain_state["rng"]]


def test_divisibility_raises_with_the_reference_words():
    mesh4 = mesh_lib.DataMesh(rank=0, size=4, device=torch.device("cpu"),
                              backend="gloo")
    with pytest.raises(ValueError, match="not divisible by mesh size 4"):
        ShardedReplay("uniform", 30, mesh4)
    buf = ShardedReplay("uniform", 32, mesh4)
    with pytest.raises(ValueError, match="sample size 6 not divisible"):
        buf.sample(6, np.random.default_rng(0))


# ---------------------------------------------------------------------------
# the CLI


def _matrix_rank(mesh, argvs):
    """Every argv through the entry point's per-rank body in one group."""
    runtimes = [train._train(mesh, train._parser().parse_args(argv))
                for argv in argvs]
    return [float(r.metrics["loss"]) for r in runtimes]


def test_cli_mesh2_composes_with_replay_and_host_actors():
    base = ["--mesh-data", "2", "--device", "cpu", "--steps", "2",
            "--batch", "8"]
    argvs = [base + ["--replay", replay, "--actors", actors]
             for actors in ("device", "host")
             for replay in ("off", "elite", "uniform")]
    losses = mesh_lib.launch(_matrix_rank, 2, device="cpu",
                             args=(argvs,), port=_port(), timeout_s=JOIN_S)
    assert len(losses) == 6 and all(np.isfinite(losses))


def test_cli_world1_with_replay_bitwise_single_process():
    """``--mesh-data 1 --replay elite`` through the entry point: learner
    state bitwise the single-process run's (both at one intra-op thread,
    as every CPU rank runs), CLEAR and priority feedback included."""
    argv = ["--device", "cpu", "--steps", "4", "--batch", "8", "--replay",
            "elite", "--replay-capacity", "32"]
    plain = train.main(argv)
    dp = train.main(argv + ["--mesh-data", "1"])
    assert dp.mesh is not None and dp.mesh.size == 1
    got, want = dp.params.state_dict(), plain.params.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    for key, tensors in plain.opt_state.items():
        assert all(torch.equal(a, b)
                   for a, b in zip(dp.opt_state[key], tensors)), key


def _read(path):
    flat, _ = ckpt_lib.load_flat(path)
    return flat, ckpt_lib.restore_structured(path, "source")


def _same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("replay", ["off", "elite"])
def test_cli_mesh2_resume_bitwise(tmp_path, monkeypatch, replay):
    monkeypatch.setattr(mesh_lib, "DEFAULT_TIMEOUT_S", JOIN_S)
    d = str(tmp_path / "ckpt")
    argv = ["--mesh-data", "2", "--device", "cpu", "--steps", "6",
            "--batch", "8", "--replay", replay, "--replay-capacity", "32",
            "--checkpoint-dir", d]
    train.main(argv + ["--checkpoint-every", "3"])
    want = _read(os.path.join(d, "step_6"))
    inner = want[1]["inner"] if replay != "off" else want[1]
    assert inner["kind"] == "ShardedDeviceSource"
    assert inner["stream"]["n"] == 2
    shutil.rmtree(os.path.join(d, "step_6"))       # as if killed there
    train.main(argv + ["--resume"])
    got = _read(os.path.join(d, "step_6"))
    assert got[0].keys() == want[0].keys()
    for k in want[0]:
        assert np.array_equal(got[0][k], want[0][k]), k
    _same_tree(got[1], want[1])
    # a checkpoint of two ranks does not load into one
    shutil.rmtree(os.path.join(d, "step_6"))
    with pytest.raises(ValueError, match="resume with the same --mesh-data"):
        train.main(["--mesh-data", "1"] + argv[2:] + ["--resume"])
