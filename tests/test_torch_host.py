"""The port's host actors (``--actors host``, the MonoBeast path) against
the reference: the inference queue and the learner queue of
tests/test_batcher.py, each case also held bitwise against the JAX
package's on the same numpy inputs; the rollout buffers; an actor pool
whose rollout stream equals the reference's bitwise given the same env
and policy; ``HostEnv`` against the batched Env at B = 1; and
``HostLoopSource`` feeding the learner, never showing the policy a
half-updated parameter set, and leaving no thread behind."""

import queue
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import actor_pool as jpool
from repro.core import batcher as jbatcher
from repro.core import rollout_buffers as jbuffers
from repro_torch.configs.atari_impala import small_train
from repro_torch.core import actor_pool as tpool
from repro_torch.core import batcher as tbatcher
from repro_torch.core import learner as learner_lib
from repro_torch.core.rollout_buffers import RolloutBuffers, rollout_specs
from repro_torch.core.runtime import Runtime
from repro_torch.core.sources import HostLoopSource, check_rollout
from repro_torch.envs import catch, gridworld
from repro_torch.envs.base import HostEnv
from repro_torch.launch import train
from repro_torch.models.convnet import AgentOutput, minatar_net
from repro_torch.optim import make_optimizer

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

T, B = 5, 4
BATCHERS = [tbatcher, jbatcher]


def _host_threads():
    return [t for t in threading.enumerate() if t.is_alive()
            and (t.name == "inference" or t.name.startswith("actor-"))]


def _equal(a, b):
    if isinstance(a, dict):                # the reference sorts dict keys
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# DynamicBatcher / BatchingQueue (tests/test_batcher.py), port vs reference


def _batch_and_scatter(mod):
    b = mod.DynamicBatcher(max_batch_size=4, timeout_ms=50,
                           pad_to_bucket=False)
    results = {}

    def actor(i):
        results[i] = b.compute(np.full((3,), i, np.float32))

    threads = [threading.Thread(target=actor, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    got = None
    while got is None:
        got = b.get_batch(timeout=1.0)
    inputs, respond, n = got
    assert n == 4 and inputs.shape == (4, 3)
    respond(inputs * 10.0)  # consumer reply
    for t in threads:
        t.join(timeout=5)
        assert not t.is_alive()
    return results, np.sort(inputs[:, 0])


def test_dynamic_batcher_batches_and_scatters():
    port, ref = (_batch_and_scatter(m) for m in BATCHERS)
    for i in range(4):
        np.testing.assert_allclose(port[0][i], np.full((3,), i * 10.0))
    _equal(port[0], ref[0])
    _equal(port[1], ref[1])


def _partial_batch(mod):
    b = mod.DynamicBatcher(max_batch_size=8, timeout_ms=10,
                           pad_to_bucket=True)
    out = {}

    def actor():
        out["r"] = b.compute({"x": np.arange(6, dtype=np.float32)
                              .reshape(2, 3), "y": np.ones(2, np.int32)})

    t = threading.Thread(target=actor)
    t.start()
    inputs, respond, n = b.get_batch(timeout=2.0)
    respond({k: v + 1 for k, v in inputs.items()})
    t.join(timeout=5)
    assert not t.is_alive()
    return n, inputs, out["r"]


def test_dynamic_batcher_timeout_partial_batch():
    (n, inputs, r), ref = (_partial_batch(m) for m in BATCHERS)
    assert n == 1
    assert inputs["x"].shape[0] == tbatcher.bucket_size(1)
    np.testing.assert_allclose(r["x"], np.arange(1.0, 7.0).reshape(2, 3))
    _equal(inputs, ref[1])
    _equal(r, ref[2])


@pytest.mark.parametrize("mod", BATCHERS, ids=["port", "reference"])
def test_dynamic_batcher_close_unblocks_actors(mod):
    b = mod.DynamicBatcher(max_batch_size=4, timeout_ms=10)
    errs = []

    def actor():
        try:
            b.compute(np.zeros(1, np.float32))
        except mod.Closed:
            errs.append("closed")

    t = threading.Thread(target=actor)
    t.start()
    time.sleep(0.05)
    b.close()
    t.join(timeout=5)
    assert errs == ["closed"] and not t.is_alive()
    with pytest.raises(mod.Closed):
        b.get_batch(timeout=0.1)


def test_dynamic_batcher_pads_to_the_bucket_like_the_reference():
    """Three requests pad to the bucket of 4 by repeating the last one,
    and only the three real rows are answered."""
    outs = []
    for mod in BATCHERS:
        b = mod.DynamicBatcher(max_batch_size=8, timeout_ms=200)
        got = {}
        threads = [threading.Thread(
            target=lambda i=i: got.__setitem__(
                i, b.compute(np.full((2,), i, np.float32))))
            for i in range(3)]
        for t in threads:
            t.start()
            time.sleep(0.02)                     # arrive in order
        inputs, respond, n = b.get_batch(timeout=2.0)
        respond(inputs * 2.0)
        for t in threads:
            t.join(timeout=5)
        outs.append((n, inputs, got))
    (n, inputs, got), (n_ref, inputs_ref, got_ref) = outs
    assert n == n_ref == 3 and inputs.shape == (4, 2)
    _equal(inputs, inputs_ref)
    np.testing.assert_array_equal(inputs[3], inputs[2])
    _equal(got, got_ref)


def test_batching_queue_stacks_batch_dim():
    batches = []
    for mod in BATCHERS:
        q = mod.BatchingQueue(batch_size=3, batch_dim=1)
        for i in range(3):
            q.put({"x": np.full((5, 2), i, np.float32),
                   "a": np.full((5,), i, np.int32)})
        batches.append(q.get(timeout=1))
    batch, ref = batches
    assert batch["x"].shape == (5, 3, 2)
    np.testing.assert_allclose(batch["x"][0, :, 0], [0, 1, 2])
    _equal(batch, ref)


@pytest.mark.parametrize("mod", BATCHERS, ids=["port", "reference"])
def test_batching_queue_close_stops_iteration(mod):
    q = mod.BatchingQueue(batch_size=2)
    q.put(np.zeros(1))
    q.close()
    assert list(q) == []
    with pytest.raises(mod.Closed):
        q.put(np.zeros(1))


def test_batching_queue_get_times_out_and_bounds_items():
    q = tbatcher.BatchingQueue(batch_size=2, max_items=1)
    assert q.get(timeout=0.01) is None
    q.put(np.zeros(1))
    errs = []

    def put():
        try:
            q.put(np.ones(1))
        except tbatcher.Closed:
            errs.append("closed")

    blocked = threading.Thread(target=put)
    blocked.start()
    blocked.join(timeout=0.05)
    assert blocked.is_alive() and q.size() == 1     # back-pressure
    q.close()
    blocked.join(timeout=5)
    assert not blocked.is_alive() and errs == ["closed"]


def test_bucket_ladder():
    for n in (1, 3, 8, 9, 100, 256, 300):
        assert tbatcher.bucket_size(n) == jbatcher.bucket_size(n)
    assert tbatcher.bucket_size(3) == 4 and tbatcher.bucket_size(300) == 300


def test_stack_unstack_roundtrip():
    trees = [{"a": np.ones(3) * i, "b": (np.zeros((2, 2)) + i,
                                         np.arange(2))} for i in range(4)]
    for axis in (0, 1):
        stacked = tbatcher.stack_trees(trees, axis=axis)
        _equal(stacked["a"], jbatcher.stack_trees(trees, axis=axis)["a"])
        back = tbatcher.unstack_tree(stacked, 4, axis=axis)
        ref = jbatcher.unstack_tree(stacked, 4, axis=axis)
        for i in range(4):
            _equal(back[i]["a"], trees[i]["a"])
            assert isinstance(back[i]["b"], tuple)
            _equal(back[i]["b"][0], ref[i]["b"][0])
            _equal(back[i]["b"][1], trees[i]["b"][1])


# ---------------------------------------------------------------------------
# RolloutBuffers (tests/test_recurrent_agent.py, tests/test_replay.py)


def test_rollout_buffers_recycling():
    specs = rollout_specs((10, 5, 1), 3, unroll_length=4)
    assert specs == jbuffers.rollout_specs((10, 5, 1), 3, unroll_length=4)
    rb = RolloutBuffers(specs, num_buffers=6)
    assert rb.qsizes() == {"free": 6, "full": 0}

    def actor(i):
        idx = rb.acquire(timeout=5)
        rb.write(idx, {
            "obs": np.full(specs["obs"][0], i, np.float32),
            "action": np.full((4,), i, np.int32),
            "behavior_logits": np.zeros((4, 3), np.float32),
            "reward": np.full((4,), float(i), np.float32),
            "done": np.zeros((4,), bool),
        })
        rb.commit(idx)

    threads = [threading.Thread(target=actor, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5)
        assert not t.is_alive()
    batch = rb.get_batch(4, timeout=5)
    assert batch["obs"].shape == (5, 4, 10, 5, 1)
    assert batch["action"].shape == (4, 4)
    assert sorted(batch["reward"][0].tolist()) == [0.0, 1.0, 2.0, 3.0]
    # indices recycled
    assert rb.qsizes() == {"free": 6, "full": 0}


def test_rollout_buffers_backpressure():
    specs = {"x": ((2,), np.float32)}
    rb = RolloutBuffers(specs, num_buffers=2)
    rb.commit(rb.acquire())
    rb.commit(rb.acquire())
    with pytest.raises(queue.Empty):
        rb.acquire(timeout=0.05)  # blocked until the learner recycles
    rb.get_batch(2, timeout=1)
    assert rb.acquire(timeout=1) in (0, 1)


def test_rollout_buffers_get_batch_returns_indices_on_timeout():
    """Learner dies mid-batch: the already-dequeued indices must come back
    to the free list, or back-pressure deadlocks the actors."""
    specs = {"reward": ((T,), np.float32)}
    rb = RolloutBuffers(specs, num_buffers=4)
    i = rb.acquire()
    rb.write(i, {"reward": np.ones(T, np.float32)})
    rb.commit(i)                               # only 1 full, need 2
    with pytest.raises(queue.Empty):
        rb.get_batch(batch_size=2, timeout=0.05)
    q = rb.qsizes()
    assert q["free"] + q["full"] == 4          # nothing leaked
    assert q["free"] == 4                      # and it is reusable


def test_rollout_buffers_batch_equals_the_reference():
    specs = rollout_specs((3, 2), 4, unroll_length=T)
    rng = np.random.default_rng(0)
    data = [{k: rng.normal(size=shape).astype(dtype)
             for k, (shape, dtype) in specs.items()} for _ in range(3)]
    batches = []
    for cls in (RolloutBuffers, jbuffers.RolloutBuffers):
        rb = cls(specs, num_buffers=3)
        for d in data:
            i = rb.acquire(timeout=1)
            rb.write(i, d)
            rb.commit(i)
        batches.append(rb.get_batch(3, timeout=1))
    _equal(*batches)


# ---------------------------------------------------------------------------
# ActorPool: the port's rollout stream is the reference's, bitwise


class _StubEnv:
    """A numpy env both packages can drive: a random walk with a seeded
    stream of rewards and episode ends."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(1000 + seed)
        self._pos = np.zeros(4, np.float32)

    def reset(self):
        self._pos = self._rng.normal(size=4).astype(np.float32)
        return self._pos.copy()

    def step(self, action):
        self._pos = self._pos + np.float32(action - 1) * 0.5
        done = bool(self._rng.random() < 0.2)
        if done:
            self._pos = self._rng.normal(size=4).astype(np.float32)
        return (self._pos.copy(), float(self._rng.normal()), done, {})


_W = np.random.default_rng(7).normal(size=(4, 3)).astype(np.float32)


def _numpy_policy(obs):
    return np.tanh(obs @ _W).astype(np.float32)


def _pool_stream(pool_mod, batcher_mod, n_rollouts, seed=5):
    inference = batcher_mod.DynamicBatcher(max_batch_size=1, timeout_ms=1.0)
    learner_queue = batcher_mod.BatchingQueue(batch_size=1, batch_dim=1,
                                              max_items=2)
    pool = pool_mod.ActorPool(_StubEnv, 1, T, inference, learner_queue,
                              seed=seed)
    thread = pool_mod.start_inference_thread(inference, _numpy_policy)
    pool.start()
    try:
        return [learner_queue.get(timeout=10) for _ in range(n_rollouts)]
    finally:
        pool.stop()
        thread.join(timeout=5)
        assert not thread.is_alive()


def test_actor_pool_stream_equals_the_reference():
    port = _pool_stream(tpool, tbatcher, 4)
    ref = _pool_stream(jpool, jbatcher, 4)
    for a, b in zip(port, ref):
        assert a is not None and b is not None
        _equal(a, b)
    assert port[0]["obs"].shape == (T + 1, 1, 4)
    assert port[0]["action"].dtype == np.int32
    assert not any(t.name.startswith("actor-") for t in _host_threads())


class _Overlap:
    """Counts the threads inside wrapped functions at once; each call
    holds ``hold_s`` first (a sleep, which lets another thread in)."""

    def __init__(self, hold_s):
        self.hold_s = hold_s
        self.inside = self.most = 0
        self.guard = threading.Lock()

    def wrap(self, fn):
        def probed(*args):
            with self.guard:
                self.inside += 1
                self.most = max(self.most, self.inside)
            time.sleep(self.hold_s)
            with self.guard:
                self.inside -= 1
            return fn(*args)
        return probed


def _pool_batch(env_fn, policy, n=4):
    """One learner batch of ``n`` actors; and the sizes of the policy's
    batches."""
    inference = tbatcher.DynamicBatcher(max_batch_size=n, timeout_ms=100.0)
    learner_queue = tbatcher.BatchingQueue(batch_size=n, batch_dim=1)
    pool = tpool.ActorPool(env_fn, n, T, inference, learner_queue)
    sizes = []

    def sized(obs):
        sizes.append(obs.shape[0])
        return policy(obs)

    thread = tpool.start_inference_thread(inference, sized)
    pool.start()
    try:
        batch = learner_queue.get(timeout=10)
    finally:
        pool.stop()
        thread.join(timeout=5)
    return batch, sizes


def test_actor_pool_steps_one_env_at_a_time():
    """A pool of HostEnvs steps one env at a time (HostEnv's lock: each
    step is many tiny torch ops that release the interpreter lock, and
    contending for it costs more than the ops), while the actors still
    wait on the inference queue together."""
    probe = _Overlap(0.005)
    env = catch.make()
    env = env._replace(transition=probe.wrap(env.transition),
                       reset_from=probe.wrap(env.reset_from))
    batch, sizes = _pool_batch(
        lambda seed: HostEnv(env, seed),
        lambda obs: np.zeros((len(obs), env.num_actions), np.float32))
    assert batch["obs"].shape == (T + 1, 4) + env.obs_shape
    assert probe.most == 1
    assert max(sizes) > 1                   # policy calls still batched


def test_actor_pool_steps_other_envs_side_by_side():
    """The pool itself serialises nothing: envs whose steps release the
    interpreter lock for real work (numpy, a C emulator) overlap."""
    probe = _Overlap(0.05)

    class _Probed(_StubEnv):
        def step(self, action):
            return probe.wrap(super().step)(action)

    batch, _ = _pool_batch(_Probed, _numpy_policy)
    assert batch["obs"].shape == (T + 1, 4, 4)
    assert probe.most > 1


# ---------------------------------------------------------------------------
# HostEnv


@pytest.mark.parametrize("env_mod", [catch, gridworld])
def test_host_env_equals_the_batched_env_at_b1(env_mod):
    env = env_mod.make()
    host = HostEnv(env, seed=3)
    gen = torch.Generator().manual_seed(3)
    state, obs = env.reset(1, gen, "cpu")
    got = host.reset()
    assert isinstance(got, np.ndarray) and got.shape == env.obs_shape
    np.testing.assert_array_equal(got, obs[0].numpy())
    actions = np.random.default_rng(0).integers(0, env.num_actions, 120)
    ended = 0
    for a in actions:
        state, obs, reward, done = env.step(state, torch.tensor([int(a)]),
                                            gen)
        o, r, d, info = host.step(int(a))
        np.testing.assert_array_equal(o, obs[0].numpy())
        assert type(r) is float and type(d) is bool and info == {}
        assert r == float(reward[0]) and d == bool(done[0])
        ended += d
    assert ended > 0                       # an auto-reset was crossed
    assert host.num_actions == env.num_actions


# ---------------------------------------------------------------------------
# HostLoopSource


def _minatar(env):
    return minatar_net(env.obs_shape, env.num_actions,
                       generator=torch.Generator().manual_seed(0))


def test_host_loop_source_feeds_the_learner_and_leaves_no_threads():
    env = catch.make()
    agent = _minatar(env)
    cfg = small_train(unroll_length=T, batch_size=B, total_steps=3)
    opt = make_optimizer(cfg)
    before = set(threading.enumerate())
    src = HostLoopSource(env, agent, num_actors=3, unroll_length=T,
                         batch_size=B, seed=1)
    batches = []
    step_fn = learner_lib.make_train_step(opt, cfg)

    def step(p, o, s, batch):
        batches.append(batch)
        return step_fn(p, o, s, batch)

    rt = Runtime(src, step, agent, opt.init(list(agent.parameters())),
                 total_steps=3, log_every=0, print_fn=lambda s: None)
    rt.run()
    assert len(batches) == 3 and rt.frames == 3 * T * B
    for batch in batches:
        check_rollout(batch, T, B)
        assert batch["obs"].shape == (T + 1, B) + env.obs_shape
    assert np.isfinite(float(rt.metrics["loss"]))
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()]
    assert leaked == [], f"stop() leaked threads: {leaked}"
    assert src.state_dict() == {"kind": "HostLoopSource"}


class _Probe(torch.nn.Module):
    """Logits a - b: zero for any parameter set the learner publishes
    (it always sets a == b), nonzero for a half-copied one."""

    def __init__(self, num_actions):
        super().__init__()
        self.a = torch.nn.Parameter(torch.zeros(num_actions))
        self.b = torch.nn.Parameter(torch.zeros(num_actions))

    def forward(self, obs):
        n = obs.shape[0]
        a = self.a.expand(n, -1).clone()
        time.sleep(0)                     # invite a switch mid-forward
        return AgentOutput(a - self.b, torch.zeros(n))


def test_policy_never_sees_a_half_updated_parameter_set():
    """The learner republishes its parameters while the inference thread
    evaluates the policy; every behavior logit must come from a whole
    parameter set. More actor threads than cores and a short switch
    interval make an unguarded copy show within a few batches."""
    env = catch.make()
    learner = _Probe(env.num_actions)
    src = HostLoopSource(env, learner, num_actors=16, unroll_length=2,
                         batch_size=8, seed=0, inference_timeout_ms=0.5)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        src.start(learner)
        deadline = time.time() + 20
        for k in range(1, 41):
            with torch.no_grad():
                learner.a.fill_(k)
                learner.b.fill_(k)
            for _ in range(5):
                src._sync(learner)
            batch = src.next_batch(learner)
            assert torch.equal(batch["behavior_logits"],
                               torch.zeros_like(batch["behavior_logits"])), k
            if time.time() > deadline:
                break
    finally:
        sys.setswitchinterval(interval)
        src.stop()
    assert _host_threads() == []


def test_stop_joins_the_inference_thread():
    env = catch.make()
    agent = _minatar(env)
    before = set(threading.enumerate())
    src = HostLoopSource(env, agent, num_actors=2, unroll_length=T,
                         batch_size=2)
    src.start(agent)
    src.next_batch(agent)
    spawned = [t for t in threading.enumerate() if t not in before]
    assert any(t.name == "inference" for t in spawned)
    assert sum(t.name.startswith("actor-") for t in spawned) == 2
    src.stop()
    leaked = [t for t in threading.enumerate()
              if t not in before and t.is_alive()]
    assert leaked == [], f"stop() leaked threads: {leaked}"
    src.stop()                           # idempotent


def test_main_actors_host_exits_cleanly(capsys):
    runtime = train.main(["--actors", "host", "--steps", "2", "--device",
                          "cpu"])
    assert isinstance(runtime.source, HostLoopSource)
    assert runtime.frames == 2 * 20 * 32
    assert np.isfinite(float(runtime.metrics["loss"]))
    assert "step     1" in capsys.readouterr().out
    assert _host_threads() == []
