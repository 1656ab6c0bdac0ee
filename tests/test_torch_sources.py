"""The port's DeviceSource and Runtime: the canonical rollout contract,
pipelined-vs-sync stream identity with frozen params, the actors' own
parameter copy under ``param_sync_every``, action sampling, and the
runtime loop."""

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs.atari_impala import small_train
from repro_torch.core import learner as learner_lib
from repro_torch.core.rollout import sample_actions
from repro_torch.core.runtime import Runtime
from repro_torch.core.sources import DeviceSource, check_rollout
from repro_torch.envs import catch, gridworld
from repro_torch.models.convnet import minatar_net
from repro_torch.optim import make_optimizer

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

T, B = 5, 4


def _agent(env, seed=0):
    return minatar_net(env.obs_shape, env.num_actions,
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("env_mod", [catch, gridworld])
def test_rollout_contract(env_mod):
    env = env_mod.make()
    src = DeviceSource.for_env(env, _agent(env), unroll_length=T,
                               batch_size=B, seed=1)
    model = _agent(env)
    r = src.next_batch(model)
    check_rollout(r, T, B)
    assert r["obs"].shape == (T + 1, B) + env.obs_shape
    assert r["behavior_logits"].shape == (T, B, env.num_actions)
    assert src.frames_per_batch == T * B
    src.stop()


def test_check_rollout_rejects_broken_layout():
    env = catch.make()
    src = DeviceSource.for_env(env, _agent(env), unroll_length=T,
                               batch_size=B, seed=1, pipelined=False)
    r = dict(src.next_batch(_agent(env)))
    r["action"] = r["action"].long()
    with pytest.raises(ValueError, match="action"):
        check_rollout(r, T, B)


def test_pipelined_equals_sync_with_frozen_params():
    """With params that never move, the double-buffered stream is the
    synchronous one (same generator draws in the same order)."""
    env = catch.make()
    model = _agent(env)
    sync = DeviceSource.for_env(env, model, unroll_length=T, batch_size=B,
                                seed=3, pipelined=False)
    pipe = DeviceSource.for_env(env, model, unroll_length=T, batch_size=B,
                                seed=3, pipelined=True)
    for _ in range(4):
        a, b = sync.next_batch(model), pipe.next_batch(model)
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("pipelined", [False, True])
def test_param_sync_every_acts_on_copied_params(pipelined):
    """The learner updates in place; between syncs the actors must act on
    the params copied at the last sync, not on the live ones."""
    env = catch.make()
    learner = _agent(env)
    src = DeviceSource.for_env(env, learner, unroll_length=T, batch_size=B,
                               seed=5, pipelined=pipelined,
                               param_sync_every=2)
    synced = copy.deepcopy(learner)

    def logits(model, rollout):
        with torch.no_grad():
            return model(rollout["obs"][:-1]).policy_logits

    first = src.next_batch(learner)          # dispatch 0 syncs (and 1)
    with torch.no_grad():                    # an in-place learner update
        learner.policy.bias.add_(torch.arange(3.0))
    moved = copy.deepcopy(learner)
    second = src.next_batch(learner)         # no sync in between
    third = src.next_batch(learner)
    torch.testing.assert_close(first["behavior_logits"],
                               logits(synced, first))
    torch.testing.assert_close(second["behavior_logits"],
                               logits(synced, second))
    assert not torch.allclose(second["behavior_logits"],
                              logits(moved, second))
    # the next sync copies the moved params
    torch.testing.assert_close(third["behavior_logits"], logits(moved, third))


def test_stop_restarts_the_sync_cadence():
    """After stop/start the first dispatch copies the learner's params,
    even where the old cadence would not have synced yet."""
    env = catch.make()
    learner = _agent(env)
    src = DeviceSource.for_env(env, learner, unroll_length=T, batch_size=B,
                               seed=7, pipelined=False, param_sync_every=3)
    src.next_batch(learner)                  # dispatch 0 syncs
    with torch.no_grad():
        learner.policy.bias.add_(torch.arange(3.0))
    src.stop()
    src.start(learner)
    r = src.next_batch(learner)
    with torch.no_grad():
        want = learner(r["obs"][:-1]).policy_logits
    torch.testing.assert_close(r["behavior_logits"], want)


def test_sample_actions_follows_softmax():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0]]).repeat(40_000, 1)
    actions = sample_actions(logits, gen)
    freq = np.bincount(actions.numpy(), minlength=4) / 40_000
    np.testing.assert_allclose(freq, torch.softmax(logits[0], 0).numpy(),
                               atol=0.01)


def test_runtime_loop_logs_and_reports():
    env = catch.make()
    cfg = small_train(unroll_length=T, batch_size=B, total_steps=4)
    model = _agent(env)
    opt = make_optimizer(cfg)
    src = DeviceSource.for_env(env, model, unroll_length=T, batch_size=B,
                               seed=1)
    lines, seen = [], []
    runtime = Runtime(src, learner_lib.make_train_step(opt, cfg), model,
                      opt.init(list(model.parameters())), total_steps=4,
                      log_every=2, log_keys=("reward_per_step", "loss"),
                      on_metrics=lambda step, m: seen.append(step),
                      print_fn=lines.append)
    runtime.run()
    assert seen == [0, 1, 2, 3]
    assert runtime.frames == 4 * T * B
    assert len(lines) == 3 and "fps=" in lines[-1] and "fps_avg=" in lines[-1]
    assert "reward/step=" in lines[0] and "loss=" in lines[0]
    assert np.isfinite(float(runtime.metrics["loss"]))

