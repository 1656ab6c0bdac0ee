"""Off-policy replay in the port (core/replay.py, ReplaySource, Runtime's
feedback hook, ``--replay``), on the CPU:

* the three buffers against the reference's ``repro.core.replay`` on the
  same numpy rollouts, insert order and ``default_rng`` seed: tickets,
  evictions, sample indices and batches, stats, priority updates and
  ``state_dict`` loaded both ways — all bitwise;
* ``ReplaySource`` against the reference's on the same fresh batches;
* the reference's contract tests (tests/test_replay.py) that need no mesh;
* the entry point: ``--replay {uniform,elite,attentive}``, ``--actors host
  --replay uniform`` (under a time limit, no thread left), and crash and
  CLI ``--resume`` with replay, bitwise.
"""

import os
import shutil
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import replay as jreplay
from repro.core import sources as jsources
from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs.atari_impala import small_train
from repro_torch.core import learner as learner_lib
from repro_torch.core import replay as treplay
from repro_torch.core.runtime import Runtime
from repro_torch.core.sources import (DeviceSource, ReplaySource,
                                      RolloutSource, check_rollout)
from repro_torch.envs import catch
from repro_torch.launch import train
from repro_torch.models.convnet import minatar_net
from repro_torch.optim import make_optimizer

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

T, B, A = 4, 3, 3
OBS = (2, 2, 1)
KINDS = ["uniform", "elite", "attentive"]
# a host-thread run that has not ended by then has hung
HOST_RUN_LIMIT_S = 120.0


def make_rollout(ids, t=T, num_actions=A, seed=0):
    """A canonical time-major numpy rollout batch whose column i is filled
    with the identifying value ids[i] (recoverable from reward[0, i])."""
    ids = np.asarray(ids, np.float32)
    b = len(ids)
    rng = np.random.default_rng(seed)
    return {
        "obs": np.broadcast_to(
            ids[None, :, None, None, None], (t + 1, b) + OBS
        ).astype(np.float32).copy(),
        "action": rng.integers(0, num_actions, (t, b)).astype(np.int32),
        "behavior_logits": rng.normal(0, 1, (t, b, num_actions)
                                      ).astype(np.float32),
        "reward": np.broadcast_to(ids[None, :], (t, b)).astype(
            np.float32).copy(),
        "done": np.zeros((t, b), bool),
    }


def _tensors(rollout):
    return {k: torch.from_numpy(v.copy()) for k, v in rollout.items()}


def contents(buf):
    """The identifying values currently stored (via the reward channel)."""
    live = np.flatnonzero(buf._live)
    return sorted(buf._arrays["reward"][i][0] for i in live)


def _agent(env, seed=0):
    return minatar_net(env.obs_shape, env.num_actions,
                       generator=torch.Generator().manual_seed(seed))


def _source(env, agent, seed):
    return DeviceSource.for_env(env, agent, unroll_length=T, batch_size=B,
                                seed=seed, pipelined=False)


def _assert_trees_equal(a, b, where=""):
    """Bitwise equality of two state trees (dicts, lists, numpy, ints)."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{where}/{i}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
    else:
        assert a == b, where


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the buffers against the reference, bitwise


def _drive(buf, rng, kind, rounds=6, priorities=None):
    """Inserts of 3 columns each into a capacity-8 buffer (so evictions
    start at round 3), a sample of 4 after each, and — for the elite
    buffer — a priority update from ``priorities`` after each sample.
    Returns everything observable, for comparison."""
    log = []
    for i in range(rounds):
        prio = None
        if kind == "elite" and i % 2:
            prio = np.array([0.5 * i, 3.0 - i, 0.25 + i])
        ids = buf.insert(make_rollout([3 * i, 3 * i + 1, 3 * i + 2],
                                      seed=i), priorities=prio)
        query = make_rollout([3 * i + 1])["obs"]
        batch, sampled = buf.sample(4, rng, query=query)
        log.append((list(ids), list(sampled), batch, buf.stats(),
                    sorted(buf._free), buf._live.copy(), buf._prio.copy()))
        if priorities is not None:
            buf.update_priorities(sampled, priorities[i])
    return log


@pytest.mark.parametrize("kind", KINDS)
def test_buffer_equals_the_reference_bitwise(kind):
    """Tickets, eviction order, sample indices, batches, stats, free list
    and priorities after every step, with the same numpy priority vectors
    fed back after each sample."""
    prios = np.random.default_rng(7).random((6, 4)) * 4.0
    got = _drive(treplay.make_buffer(kind, 8), np.random.default_rng(42),
                 kind, priorities=prios)
    want = _drive(jreplay.make_buffer(kind, 8), np.random.default_rng(42),
                  kind, priorities=prios)
    for step, (g, w) in enumerate(zip(got, want)):
        ids_g, sam_g, batch_g, stats_g, free_g, live_g, prio_g = g
        ids_w, sam_w, batch_w, stats_w, free_w, live_w, prio_w = w
        assert ids_g == ids_w, step
        assert sam_g == sam_w, step
        _assert_batches_equal(batch_g, batch_w)
        assert stats_g == stats_w, step
        assert free_g == free_w, step
        np.testing.assert_array_equal(live_g, live_w)
        np.testing.assert_array_equal(prio_g, prio_w)
    assert got[-1][3]["evicted"] > 0          # eviction was exercised


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("kind", KINDS)
def test_state_dict_loads_across_packages(kind, direction):
    """One package's ``state_dict`` loads into the other's buffer, and
    sampling, insertion, eviction and priority updates go on identically
    in both afterwards."""
    src_mod, dst_mod = (jreplay, treplay) if direction == \
        "reference_to_port" else (treplay, jreplay)
    src = src_mod.make_buffer(kind, 8)
    _drive(src, np.random.default_rng(3), kind, rounds=4)
    dst = dst_mod.make_buffer(kind, 8)
    dst.load_state_dict(src.state_dict())
    _assert_trees_equal(dst.state_dict(), src.state_dict())
    prios = np.random.default_rng(8).random((3, 4))
    a = _drive(src, np.random.default_rng(5), kind, rounds=3,
               priorities=prios)
    b = _drive(dst, np.random.default_rng(5), kind, rounds=3,
               priorities=prios)
    for x, y in zip(a, b):
        assert x[:2] == y[:2]
        _assert_batches_equal(x[2], y[2])
        assert x[3] == y[3]
    _assert_trees_equal(dst.state_dict(), src.state_dict())


def test_buffer_refuses_another_kind_or_capacity():
    state = treplay.EliteReplay(4).state_dict()
    with pytest.raises(ValueError, match="same --replay flags"):
        treplay.UniformReplay(4).load_state_dict(state)
    with pytest.raises(ValueError, match="same --replay-capacity"):
        treplay.EliteReplay(8).load_state_dict(state)


# ---------------------------------------------------------------------------
# ReplaySource against the reference's, on the same fresh batches


class _ListSource:
    """Hands out the given rollouts in turn (numpy for the reference,
    tensors for the port)."""

    frames_per_batch = T * B

    def __init__(self, rollouts):
        self._rollouts = list(rollouts)
        self.stopped = False

    def start(self, params):
        pass

    def next_batch(self, params):
        return self._rollouts.pop(0)

    def stop(self):
        self.stopped = True

    def state_dict(self):
        return {"kind": "list", "left": len(self._rollouts)}

    def load_state_dict(self, state):
        pass


def _values(params, obs):
    """A value function both frameworks compute exactly: (T, B)."""
    del params
    return obs[:, :, 0, 0, 0] * 2.0 - 1.0


@pytest.mark.parametrize("kind", KINDS)
def test_replay_source_equals_the_reference(kind):
    """Mixed batches (fresh first, then replayed), ``is_replay``, recorded
    ``behavior_value``, emitted tickets, priority feedback and stats, over
    the same fresh stream, seed and priority vectors."""
    rollouts = [make_rollout(np.arange(3) + 10 * i, seed=i)
                for i in range(6)]
    ref = jsources.ReplaySource(
        _ListSource(rollouts), jreplay.make_buffer(kind, 8),
        replay_ratio=1.0, seed=4,
        value_fn=lambda p, obs: _values(p, jnp.asarray(obs)))
    port = ReplaySource(
        _ListSource([_tensors(r) for r in rollouts]),
        treplay.make_buffer(kind, 8), replay_ratio=1.0, seed=4,
        value_fn=_values)
    prios = np.random.default_rng(9).random((6, 2 * B)).astype(np.float32)
    for i in range(6):
        want = ref.next_batch(None)
        got = port.next_batch(None)
        _assert_batches_equal(got, want)
        assert got["is_replay"].dtype == torch.bool
        assert port._last_ids == ref._last_ids
        ref.on_learner_metrics(i, {"priority": jnp.asarray(prios[i])})
        port.on_learner_metrics(i, {"priority": torch.from_numpy(prios[i])})
        assert port.stats() == ref.stats()
    _assert_trees_equal(port.buffer.state_dict(), ref.buffer.state_dict())
    _assert_trees_equal(port.state_dict()["rng"], ref.state_dict()["rng"])


# ---------------------------------------------------------------------------
# the reference's contract tests (tests/test_replay.py) without a mesh


@pytest.mark.parametrize("kind", ["uniform", "attentive"])
def test_fifo_eviction_evicts_oldest(kind):
    buf = treplay.make_buffer(kind, 4)
    buf.insert(make_rollout([0, 1, 2]))
    buf.insert(make_rollout([3, 4, 5]))       # capacity 4: evicts 0 and 1
    assert len(buf) == 4
    assert contents(buf) == [2, 3, 4, 5]
    assert buf.evicted == 2


def test_elite_eviction_evicts_lowest_priority_first():
    buf = treplay.EliteReplay(4)
    buf.insert(make_rollout([0, 1, 2, 3]),
               priorities=np.array([5.0, 1.0, 4.0, 3.0]))
    buf.insert(make_rollout([9]), priorities=np.array([2.0]))
    assert contents(buf) == [0, 2, 3, 9]      # prio-1.0 rollout (id 1) died
    buf.insert(make_rollout([8]), priorities=np.array([6.0]))
    assert contents(buf) == [0, 2, 3, 8]      # next lowest was id 9 (2.0)


def test_optimistic_default_priority_for_unscored_inserts():
    buf = treplay.EliteReplay(8)
    buf.insert(make_rollout([0, 1]), priorities=np.array([7.0, 2.0]))
    buf.insert(make_rollout([2]))             # unscored -> current max (7.0)
    live = np.flatnonzero(buf._live)
    assert buf._prio[live].max() == buf._prio[live[-1]] == 7.0


def test_priority_update_ignores_evicted_slots():
    buf = treplay.EliteReplay(2)
    ids = buf.insert(make_rollout([0, 1]))
    buf.sample(2, np.random.default_rng(0))
    buf.insert(make_rollout([2, 3]), priorities=np.array([9.0, 9.0]))
    # ids were fully evicted; a stale update must not resurrect them
    buf.update_priorities(ids, np.array([100.0, 100.0]))
    live = np.flatnonzero(buf._live)
    assert (buf._prio[live] == 9.0).all()


def test_attentive_samples_nearest_observations():
    buf = treplay.AttentiveReplay(8)
    buf.insert(make_rollout([0.0, 0.0, 0.0]))       # obs ~ 0
    buf.insert(make_rollout([10.0, 10.0, 10.0]))    # obs ~ 10
    sampled, _ = buf.sample(3, np.random.default_rng(0),
                            query=make_rollout([9.0, 9.0, 9.0])["obs"])
    assert (sampled["reward"] == 10.0).all()
    sampled, _ = buf.sample(3, np.random.default_rng(0),
                            query=make_rollout([1.0, 1.0, 1.0])["obs"])
    assert (sampled["reward"] == 0.0).all()
    # k beyond the live rollouts wraps around the nearest-first order
    sampled, ids = buf.sample(8, np.random.default_rng(0),
                              query=make_rollout([9.0])["obs"])
    assert len(ids) == 8 and ids[:6] == ids[6:] + ids[2:6]


@pytest.mark.parametrize("kind", KINDS)
def test_sampling_deterministic_under_fixed_seed(kind):
    def run():
        buf = treplay.make_buffer(kind, 8)
        rng = np.random.default_rng(42)
        out = []
        for i in range(4):
            buf.insert(make_rollout([3 * i, 3 * i + 1, 3 * i + 2], seed=i))
            sampled, ids = buf.sample(
                4, rng, query=make_rollout([3 * i]).get("obs"))
            out.append((tuple(ids), sampled["reward"].copy()))
        return out

    a, b = run(), run()
    for (ids_a, r_a), (ids_b, r_b) in zip(a, b):
        assert ids_a == ids_b
        np.testing.assert_array_equal(r_a, r_b)


def test_replay_insert_returns_slot_on_malformed_rollout():
    buf = treplay.UniformReplay(4)
    buf.insert(make_rollout([0, 1]))
    bad = make_rollout([2])
    bad["obs"] = bad["obs"][:, :, :1]          # wrong feature shape
    with pytest.raises(ValueError):
        buf.insert(bad)
    assert len(buf) == 2
    assert len(buf._free) + len(buf) == buf.capacity
    buf.insert(make_rollout([3, 4]))           # buffer still fully usable
    assert len(buf) == 4


def test_buffer_protocol():
    for kind in KINDS:
        assert isinstance(treplay.make_buffer(kind, 4), treplay.ReplayBuffer)
    with pytest.raises(ValueError, match="unknown replay kind"):
        treplay.make_buffer("nope", 4)


@pytest.mark.parametrize("kind", KINDS)
def test_replay_source_satisfies_rollout_source_contract(kind):
    env = catch.make()
    agent = _agent(env)
    rs = ReplaySource(_source(env, agent, 2), treplay.make_buffer(kind, 16),
                      replay_ratio=1.0, seed=0)
    assert isinstance(rs, RolloutSource)
    assert rs.frames_per_batch == T * B       # fresh env frames only
    try:
        rs.start(agent)
        for _ in range(3):
            batch = rs.next_batch(agent)
            check_rollout(batch, T, 2 * B)    # 1:1 mix -> 2B columns
            assert batch["is_replay"].shape == (2 * B,)
            assert int(batch["is_replay"].sum()) == B
            assert not bool(batch["is_replay"][:B].any())
            assert set(rs.split_ms) == {"inner", "to_host", "sample",
                                        "insert", "to_device"}
    finally:
        rs.stop()


def test_replay_ratio_zero_passes_through_fresh_batches():
    env = catch.make()
    agent = _agent(env)
    inner = _source(env, agent, 3)
    rs = ReplaySource(inner, treplay.make_buffer("uniform", 8),
                      replay_ratio=0.0)
    twin = _source(env, agent, 3)
    rs.start(agent)
    batch = rs.next_batch(agent)
    check_rollout(batch, T, B)
    assert not bool(batch["is_replay"].any())
    assert len(rs.buffer) == B                # still feeds the buffer
    want = twin.next_batch(agent)
    for k in want:                            # the fresh batch, unchanged
        assert torch.equal(batch[k], want[k]), k
    rs.stop()


def test_value_fn_records_behavior_values_through_replay_source():
    """``behavior_value`` is the acting network's baseline on the fresh
    columns (recorded with no graph), carried back with replayed ones, and
    the CLEAR terms of a learner step on the batch are finite."""
    env = catch.make()
    agent = _agent(env)
    tc = small_train(unroll_length=T, batch_size=B, total_steps=10,
                     clear_policy_cost=0.01, clear_value_cost=0.005)
    opt = make_optimizer(tc)
    rs = ReplaySource(_source(env, agent, 6),
                      treplay.make_buffer("uniform", 16), replay_ratio=1.0,
                      value_fn=lambda p, obs: p(obs).baseline)
    step = learner_lib.make_train_step(opt, tc)
    rs.start(agent)
    try:
        batch = rs.next_batch(agent)
        assert batch["behavior_value"].shape == (T, 2 * B)
        assert not batch["behavior_value"].requires_grad
        check_rollout(batch, T, 2 * B)
        with torch.no_grad():
            want = agent(batch["obs"][:-1, :B]).baseline
        assert torch.equal(batch["behavior_value"][:, :B], want)
        _, _, m = step(agent, opt.init(list(agent.parameters())), 0, batch)
        assert torch.isfinite(m["clear_value_loss"])
        assert torch.isfinite(m["clear_policy_loss"])
    finally:
        rs.stop()


def test_replayed_rows_predate_current_step():
    """Sampling happens before insertion: after warmup, every replayed
    column comes from an earlier step."""
    env = catch.make()
    agent = _agent(env)
    rs = ReplaySource(_source(env, agent, 7),
                      treplay.make_buffer("attentive", 32), replay_ratio=1.0)
    rs.start(agent)
    try:
        rs.next_batch(agent)               # warmup: samples itself
        for _ in range(3):
            rs.next_batch(agent)
            assert not set(rs._last_ids[:B]) & set(rs._last_ids[B:])
    finally:
        rs.stop()
    assert rs.stats()["replay_hit_rate"] == pytest.approx(3 * B / (4 * B))


class _DyingSource(_ListSource):
    def __init__(self, die):
        super().__init__([_tensors(make_rollout([0, 1, 2]))])
        self.die = die

    def stop(self):
        super().stop()
        if self.die:
            raise RuntimeError("learner died mid-batch")


@pytest.mark.parametrize("inner_stop", ["returns", "raises"])
def test_replay_source_stop_recycles_all_slots(inner_stop):
    buf = treplay.make_buffer("uniform", 8)
    inner = _DyingSource(die=inner_stop == "raises")
    rs = ReplaySource(inner, buf, replay_ratio=1.0)
    rs.start(None)
    rs.next_batch(None)
    assert len(buf) == 3 and rs._last_ids
    if inner_stop == "raises":
        with pytest.raises(RuntimeError, match="mid-batch"):
            rs.stop()
    else:
        rs.stop()
    assert inner.stopped
    assert len(buf) == 0                      # slots recycled regardless
    assert len(buf._free) == buf.capacity
    assert rs._last_ids == []


def test_mixed_batch_fails_loudly_on_fresh_only_keys():
    """A key present in the fresh rollout but absent from the sampled
    replay columns must not silently vanish from the emitted batch."""
    second = make_rollout([0.0, 1.0, 2.0])
    second["aux"] = np.zeros((T, 3), np.float32)
    rs = ReplaySource(
        _ListSource([_tensors(make_rollout([0.0, 1.0, 2.0])),
                     _tensors(second)]),
        treplay.make_buffer("uniform", 8), replay_ratio=1.0)
    rs.start(None)
    rs.next_batch(None)                     # schema fixed without "aux"
    with pytest.raises(KeyError, match="fresh-only keys \\['aux'\\]"):
        rs.next_batch(None)


def test_priority_shape_mismatch_warns_once_and_counts():
    rs = ReplaySource(_ListSource([_tensors(make_rollout([0, 1, 2]))]),
                      treplay.make_buffer("elite", 16), replay_ratio=1.0)
    rs.start(None)
    rs.next_batch(None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rs.on_learner_metrics(0, {"priority": torch.ones(3)})
        rs.on_learner_metrics(1, {"priority": torch.ones(2 * B + 1)})
        rs.on_learner_metrics(2, {"priority": torch.ones(2 * B)})
    assert len(caught) == 1                       # warn once, not spam
    assert "degrading to uniform" in str(caught[0].message)
    assert rs.stats()["replay_priority_drops"] == 2.0


def test_elite_priority_feedback_through_the_runtime():
    """Runtime -> train-step ``priority`` (2B columns, a tensor) ->
    ReplaySource.on_learner_metrics -> buffer priorities move off the
    optimistic default, to the learner's values; the gauges join the log
    line."""
    env = catch.make()
    agent = _agent(env)
    tc = small_train(unroll_length=T, batch_size=B, total_steps=3,
                     clear_policy_cost=0.01, clear_value_cost=0.005)
    opt = make_optimizer(tc)
    buf = treplay.EliteReplay(16)
    rs = ReplaySource(_source(env, agent, 1), buf, replay_ratio=1.0)
    seen = {}

    def on_metrics(step, metrics):
        # the source's hook ran first: the last batch's live tickets carry
        # the learner's priorities now
        slots = [buf._slot_of_ticket[i] for i in rs._last_ids
                 if i in buf._slot_of_ticket]
        seen[step] = (metrics["priority"].shape,
                      buf._prio[slots].copy(),
                      metrics["priority"].double().numpy()[:len(slots)])

    lines = []
    Runtime(rs, learner_lib.make_train_step(opt, tc), agent,
            opt.init(list(agent.parameters())), total_steps=3,
            log_every=1, on_metrics=on_metrics, print_fn=lines.append).run()
    assert sorted(seen) == [0, 1, 2]
    for step, (shape, prio, want) in seen.items():
        assert shape == (2 * B,)
        assert not np.all(prio == 1.0)
        if step:   # (step 0 replays its own columns: the later write wins)
            np.testing.assert_array_equal(prio[:B],
                                          np.maximum(want[:B], 1e-3))
    assert "occupancy=" in lines[0] and "hit_rate=" in lines[0]
    assert len(buf) == 0                       # stop() recycled the slots


# ---------------------------------------------------------------------------
# the entry point on the CPU


def _within(limit_s, fn):
    """fn() on a worker thread; fails the test if it has not returned
    within ``limit_s`` (a hang fails this test, not the suite)."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as exc:  # re-raised on the test's thread
            out["error"] = exc

    t = threading.Thread(target=run, name="test-run", daemon=True)
    t.start()
    t.join(limit_s)
    assert not t.is_alive(), f"run still going after {limit_s}s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _host_threads():
    return [t.name for t in threading.enumerate() if t.is_alive()
            and (t.name == "inference" or t.name.startswith("actor-"))]


@pytest.mark.parametrize("kind", KINDS)
def test_main_replay_on_cpu(kind, capsys):
    runtime = train.main(["--device", "cpu", "--steps", "3", "--batch", "8",
                          "--replay", kind, "--replay-capacity", "16"])
    assert isinstance(runtime.source, ReplaySource)
    assert runtime.source.buffer.capacity == 16
    assert runtime.frames == 3 * 20 * 8       # fresh frames only
    assert runtime.metrics["priority"].shape == (16,)
    for key in ("loss", "clear_policy_loss", "clear_value_loss"):
        assert np.isfinite(float(runtime.metrics[key])), key
    out = capsys.readouterr().out
    assert "occupancy=" in out and "mean_priority=" in out


def test_main_replay_sets_the_clear_costs(monkeypatch):
    """``--replay`` wraps the source and turns the CLEAR costs on at the
    reference's 0.01 / 0.005; without it they stay 0."""
    cfgs = []
    real = train.learner_lib.make_train_step
    monkeypatch.setattr(train.learner_lib, "make_train_step",
                        lambda opt, cfg, **kw: cfgs.append(cfg)
                        or real(opt, cfg, **kw))
    args = train._parser().parse_args(["--replay", "elite", "--device",
                                       "cpu"])
    assert args.replay_capacity == 512 and args.replay_ratio == 1.0
    source, _, _, _, _ = train.build_rl_agent(args)
    assert isinstance(source, ReplaySource)
    assert isinstance(source.buffer, treplay.EliteReplay)
    assert (cfgs[-1].clear_policy_cost, cfgs[-1].clear_value_cost) == \
        (0.01, 0.005)
    off = train._parser().parse_args(["--device", "cpu"])
    assert off.replay == "off"
    assert isinstance(train.build_rl_agent(off)[0], DeviceSource)
    assert (cfgs[-1].clear_policy_cost, cfgs[-1].clear_value_cost) == \
        (0.0, 0.0)


def test_main_actors_host_replay_exits_cleanly(capsys):
    runtime = _within(HOST_RUN_LIMIT_S, lambda: train.main(
        ["--actors", "host", "--replay", "uniform", "--steps", "2",
         "--batch", "8", "--device", "cpu"]))
    assert isinstance(runtime.source, ReplaySource)
    assert runtime.frames == 2 * 20 * 8
    assert np.isfinite(float(runtime.metrics["loss"]))
    assert "hit_rate=" in capsys.readouterr().out
    assert _host_threads() == []
    assert len(runtime.source.buffer) == 0


_CLI = ["--device", "cpu", "--batch", "8", "--replay", "elite",
        "--replay-capacity", "24"]


def _final_state(runtime):
    return {**{f"params/{k}": v for k, v in
               runtime.params.state_dict().items()},
            **{f"opt/{k}/{i}": t for k, ts in runtime.opt_state.items()
               for i, t in enumerate(ts)}}


def _assert_states_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_cli_resume_with_replay_bit_identical(tmp_path):
    """``--replay elite --steps 6 --checkpoint-every 3``, cut back to its
    step-3 checkpoint, then ``--resume``: params, optimizer state and the
    whole final checkpoint — replay buffer, sampling generator and
    feedback bookkeeping included — equal an uninterrupted run's."""
    d_ref, d = str(tmp_path / "ref"), str(tmp_path / "run")
    ref = train.main(_CLI + ["--steps", "6", "--checkpoint-dir", d_ref])
    train.main(_CLI + ["--steps", "6", "--checkpoint-every", "3",
                       "--checkpoint-dir", d])
    shutil.rmtree(os.path.join(d, "step_6"))  # as if killed after step 3
    resumed = train.main(_CLI + ["--steps", "6", "--checkpoint-dir", d,
                                 "--resume"])
    _assert_states_equal(_final_state(ref), _final_state(resumed))
    flat_ref, _ = ckpt_lib.load_flat(os.path.join(d_ref, "step_6"))
    flat, _ = ckpt_lib.load_flat(os.path.join(d, "step_6"))
    assert set(flat) == set(flat_ref)
    for k in flat:
        np.testing.assert_array_equal(flat[k], flat_ref[k], err_msg=k)
    got = ckpt_lib.restore_structured(os.path.join(d, "step_6"), "source")
    want = ckpt_lib.restore_structured(os.path.join(d_ref, "step_6"),
                                       "source")
    assert want["kind"] == "ReplaySource"
    assert want["buffer"]["arrays"]["obs"].shape[0] == 24
    _assert_trees_equal(got, want)


def test_crash_resume_with_replay_bit_identical(tmp_path):
    """A replay run that dies after step 4's update (crash checkpoint
    step_5) and resumes reaches the uninterrupted run's params, optimizer
    state and replay state, bitwise."""
    d = str(tmp_path / "crash")
    args = train._parser().parse_args(_CLI + ["--steps", "8"])

    def run(checkpoint_dir=None, on_metrics=None, resume=False):
        source, step_fn, agent, opt_state, _ = train.build_rl_agent(args)
        start = 0
        if resume:
            opt_state, start = train._resume(
                train._parser().parse_args(
                    _CLI + ["--steps", "8", "--checkpoint-dir", d,
                            "--resume"]), source, agent, opt_state)
        rt = Runtime(source, step_fn, agent, opt_state, total_steps=8,
                     start_step=start, log_every=0, print_fn=lambda s: None,
                     checkpoint_dir=checkpoint_dir, on_metrics=on_metrics)
        states = {}
        real_stop = source.stop
        source.stop = lambda: (states.update(source.state_dict()),
                               real_stop())
        rt.run()
        return rt, states

    want, want_src = run()

    def boom(step, metrics):
        if step == 4:
            raise RuntimeError("killed")

    with pytest.raises(RuntimeError, match="killed"):
        run(checkpoint_dir=d, on_metrics=boom)
    assert ckpt_lib.latest_step_path(d).endswith("step_5")
    got, got_src = run(resume=True)
    _assert_states_equal(_final_state(want), _final_state(got))
    _assert_trees_equal(got_src["buffer"], want_src["buffer"])
    _assert_trees_equal(got_src["rng"], want_src["rng"])
    assert got_src["last_ids"] == want_src["last_ids"]


def test_pcg64_state_round_trips_through_a_checkpoint(tmp_path):
    """The sampling generator's 128-bit integers survive the structured
    checkpoint layer exactly, and the restored generator draws the same
    numbers."""
    rng = np.random.default_rng(2**100 + 12345)
    rng.random(7)
    state = rng.bit_generator.state
    assert state["state"]["state"] >= 2**64 or state["state"]["inc"] >= 2**64
    path = str(tmp_path / "step_1")
    ckpt_lib.save(path, {"x": torch.zeros(1)}, {},
                  structured={"source": {"rng": state}})
    back = ckpt_lib.restore_structured(path, "source")["rng"]
    assert back == state
    again = np.random.default_rng()
    again.bit_generator.state = back
    np.testing.assert_array_equal(again.random(5), rng.random(5))
