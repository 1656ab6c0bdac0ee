"""SourceState and resume in the port: a killed-and-resumed run is
BIT-IDENTICAL to an uninterrupted one, as tests/test_resume.py pins for
the reference.

* ``DeviceSource.state_dict``/``load_state_dict`` round-trip through a
  checkpoint: the restored source emits the exact same rollout stream
  (pipelined or not, with the actors' parameter copy lagging at
  ``param_sync_every=2``);
* a Runtime crash mid-training, resumed from the crash checkpoint, reaches
  final params bitwise equal to an uninterrupted run;
* a crash snapshot never overwrites a boundary checkpoint, and the final
  checkpoint holds the live source state;
* through the CLI: a run checkpointed every 3 steps and resumed from its
  step-3 checkpoint ends bitwise where the uninterrupted run ends; the
  resumed run logs only the steps it ran;
* resuming into another env or another source kind fails loudly.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs.atari_impala import small_train
from repro_torch.core import learner as learner_lib
from repro_torch.core.runtime import Runtime
from repro_torch.core.sources import DeviceSource, HostLoopSource
from repro_torch.envs import catch, gridworld
from repro_torch.launch import train
from repro_torch.models.convnet import minatar_net
from repro_torch.optim import make_optimizer

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

T, B = 5, 4


def _agent(env):
    return minatar_net(env.obs_shape, env.num_actions,
                       generator=torch.Generator().manual_seed(0))


def _assert_states_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# per-source state round trip


@pytest.mark.parametrize("env_mod", [catch, gridworld])
@pytest.mark.parametrize("pipelined", [False, True])
def test_device_source_state_roundtrip(tmp_path, pipelined, env_mod):
    env = env_mod.make()
    learner = _agent(env)

    def make(seed):
        return DeviceSource.for_env(env, learner, unroll_length=T,
                                    batch_size=B, seed=seed,
                                    pipelined=pipelined, param_sync_every=2)

    a = make(3)
    for i in range(3):
        a.next_batch(learner)
        with torch.no_grad():      # the learner moves between dispatches
            learner.policy.bias.add_(0.5 * (i + 1))
    path = str(tmp_path / "step_3")
    ckpt_lib.save(path, {"x": torch.zeros(1)}, {},
                  structured={"source": a.state_dict()})
    b = make(99)                   # different seed: the state must win
    b.load_state_dict(ckpt_lib.restore_structured(path, "source"))
    assert b._dispatches == a._dispatches
    _assert_states_equal(a._actor.state_dict(), b._actor.state_dict())
    for i in range(3):
        _assert_batches_equal(a.next_batch(learner), b.next_batch(learner))
        with torch.no_grad():
            learner.policy.bias.add_(0.25)


def test_resume_composition_mismatch_fails_loudly():
    env = catch.make()
    agent = _agent(env)
    dev = DeviceSource.for_env(env, agent, unroll_length=T, batch_size=B,
                               seed=1)
    host = HostLoopSource(env, agent, num_actors=2, unroll_length=T,
                          batch_size=B)
    # saved with --actors host, resumed with device actors (and back)
    with pytest.raises(ValueError, match="same source flags"):
        dev.load_state_dict(host.state_dict())
    with pytest.raises(ValueError, match="same source flags"):
        host.load_state_dict(dev.state_dict())
    host.load_state_dict(host.state_dict())


# ---------------------------------------------------------------------------
# the full guarantee, in process: crash -> resume == uninterrupted


def _parts(seed=11, total_steps=8):
    env = catch.make()
    agent = _agent(env)
    tc = small_train(unroll_length=T, batch_size=B, total_steps=total_steps)
    opt = make_optimizer(tc)

    def make_source(model):
        return DeviceSource.for_env(env, model, unroll_length=T,
                                    batch_size=B, seed=seed,
                                    pipelined=True)

    return agent, opt, learner_lib.make_train_step(opt, tc), make_source


def _resume_from(path, agent, opt, step, make_source, total_steps):
    restored, meta = ckpt_lib.restore(
        path, {"params": agent.state_dict(),
               "opt_state": opt.init(list(agent.parameters()))})
    agent.load_state_dict(restored["params"])
    source = make_source(agent)
    source.load_state_dict(ckpt_lib.restore_structured(path, "source"))
    rt = Runtime(source, step, agent, restored["opt_state"],
                 total_steps=total_steps, start_step=meta["step"],
                 log_every=0, print_fn=lambda s: None)
    return rt.run()


def test_crash_resume_bit_identical_to_uninterrupted(tmp_path):
    """A run that dies mid-training (crash checkpoint) and resumes reaches
    final params and optimizer state BITWISE equal to a run that never
    died — env carry, generator state and the in-flight pipelined
    rollout all resume exactly."""
    agent0, opt, step, make_source = _parts()
    init = {k: v.clone() for k, v in agent0.state_dict().items()}

    def fresh():
        agent = _agent(catch.make())
        agent.load_state_dict(init)
        return agent

    a = fresh()
    rt = Runtime(make_source(a), step, a, opt.init(list(a.parameters())),
                 total_steps=8, log_every=0, print_fn=lambda s: None)
    params_a, opt_a = rt.run()

    # crash at step 5 (after the update: outside step_fn), resume
    def boom(s, m):
        if s == 5:
            raise RuntimeError("killed")

    b = fresh()
    rt1 = Runtime(make_source(b), step, b, opt.init(list(b.parameters())),
                  total_steps=8, log_every=0, on_metrics=boom,
                  checkpoint_dir=str(tmp_path), print_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="killed"):
        rt1.run()
    path = ckpt_lib.latest_step_path(str(tmp_path))
    assert os.path.basename(path) == "step_6"
    c = fresh()
    params_b, opt_b = _resume_from(path, c, opt, step, make_source, 8)
    _assert_states_equal(params_a.state_dict(), params_b.state_dict())
    for x, y in zip(opt_a["ms"], opt_b["ms"]):
        assert torch.equal(x, y)


class _AdvanceThenFail:
    """A source whose ``fail_at``-th next_batch advances the inner source
    and then raises: a crash snapshot taken now would hold a source that
    is one dispatch ahead of the saved step."""

    def __init__(self, inner, fail_at):
        self.inner, self.fail_at, self.calls = inner, fail_at, 0
        self.frames_per_batch = inner.frames_per_batch

    def start(self, params):
        self.inner.start(params)

    def next_batch(self, params):
        batch = self.inner.next_batch(params)
        self.calls += 1
        if self.calls == self.fail_at:
            raise TimeoutError("actors stalled after dispatch")
        return batch

    def stop(self):
        self.inner.stop()

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)


@pytest.mark.parametrize("where", ["source", "step_fn"])
def test_crash_snapshot_never_clobbers_boundary_checkpoint(tmp_path, where):
    """A crash during step 5, with a periodic boundary checkpoint already
    written at step 5: whether the source had advanced (a failure in
    next_batch) or the learner died mid-update (in step_fn), the boundary
    checkpoint stays as it was, and resuming from it is still bitwise."""
    agent0, opt, step, make_source = _parts(seed=21)
    init = {k: v.clone() for k, v in agent0.state_dict().items()}

    def fresh():
        agent = _agent(catch.make())
        agent.load_state_dict(init)
        return agent

    a = fresh()
    params_ref, _ = Runtime(make_source(a), step, a,
                            opt.init(list(a.parameters())), total_steps=8,
                            log_every=0, print_fn=lambda s: None).run()

    calls = {"n": 0}

    def crashing_step(p, o, s, batch):
        if calls["n"] == 5:
            raise TimeoutError("learner stalled mid-step")
        calls["n"] += 1
        return step(p, o, s, batch)

    b = fresh()
    source = make_source(b)
    step_fn = step
    if where == "source":
        source = _AdvanceThenFail(source, fail_at=6)
    else:
        step_fn = crashing_step
    lines = []
    rt1 = Runtime(source, step_fn, b, opt.init(list(b.parameters())),
                  total_steps=8, log_every=0, checkpoint_dir=str(tmp_path),
                  checkpoint_every=5, print_fn=lines.append)
    with pytest.raises(TimeoutError):
        rt1.run()
    assert any("crash checkpoint skipped" in ln for ln in lines)
    assert sorted(os.listdir(tmp_path)) == ["step_5"]
    assert [ln for ln in lines if ln.startswith("saved ")] == [
        f"saved {tmp_path}/step_5"]             # written once, never again

    path = ckpt_lib.latest_step_path(str(tmp_path))
    assert os.path.basename(path) == "step_5"
    c = fresh()
    params_b, _ = _resume_from(path, c, opt, step, make_source, 8)
    _assert_states_equal(params_ref.state_dict(), params_b.state_dict())


def test_final_checkpoint_captures_live_source_state(tmp_path):
    """The final checkpoint is written BEFORE source.stop() — it must hold
    the live stream state (stop() resets it), so run-to-N-then-resume
    continues the exact stream."""
    agent, opt, step, make_source = _parts(seed=2)
    rt = Runtime(make_source(agent), step, agent,
                 opt.init(list(agent.parameters())), total_steps=3,
                 log_every=0, checkpoint_dir=str(tmp_path),
                 print_fn=lambda s: None)
    rt.run()
    state = ckpt_lib.restore_structured(str(tmp_path / "step_3"), "source")
    assert state["kind"] == "DeviceSource"
    assert state["dispatches"] == 4         # live state, not the reset one
    assert state["pending"] is not None     # in-flight rollout captured
    assert state["pending"]["obs"].shape == (T + 1, B, 10, 5, 1)


# ---------------------------------------------------------------------------
# through the CLI


_CLI = ["--env", "catch", "--device", "cpu", "--batch", "8"]


def test_cli_resume_bit_identical_to_uninterrupted(tmp_path):
    """``--steps 6 --checkpoint-every 3``, cut back to its step-3
    checkpoint, then ``--steps 6 --resume``: the final params and optimizer
    state are bitwise those of an uninterrupted ``--steps 6`` run. (The
    horizon stays 6 in every leg: the linear LR anneal runs over
    ``--steps``.)"""
    d_ref, d = str(tmp_path / "ref"), str(tmp_path / "run")
    ref = train.main(_CLI + ["--steps", "6", "--checkpoint-dir", d_ref])
    train.main(_CLI + ["--steps", "6", "--checkpoint-every", "3",
                       "--checkpoint-dir", d])
    assert sorted(os.listdir(d)) == ["step_3", "step_6"]
    shutil.rmtree(os.path.join(d, "step_6"))  # as if killed after step 3
    resumed = train.main(_CLI + ["--steps", "6", "--checkpoint-dir", d,
                                 "--resume"])
    _assert_states_equal(ref.params.state_dict(),
                         resumed.params.state_dict())
    flat_ref, _ = ckpt_lib.load_flat(os.path.join(d_ref, "step_6"))
    flat, meta = ckpt_lib.load_flat(os.path.join(d, "step_6"))
    assert meta["step"] == 6 and set(flat) == set(flat_ref)
    for k in flat:
        np.testing.assert_array_equal(flat[k], flat_ref[k], err_msg=k)


def test_cli_resume_logs_only_the_remaining_steps(tmp_path, capsys):
    d = str(tmp_path)
    train.main(_CLI + ["--steps", "3", "--checkpoint-dir", d])
    capsys.readouterr()
    runtime = train.main(_CLI + ["--steps", "6", "--checkpoint-dir", d,
                                 "--resume"])
    out = capsys.readouterr().out
    assert f"resumed {d}/step_3 at step 3 (source state restored)" in out
    steps = [int(ln.split()[1]) for ln in out.splitlines()
             if ln.startswith("step ")]
    assert steps == [3, 4, 5]
    assert runtime.frames == 3 * 20 * 8
    assert ckpt_lib.is_complete(os.path.join(d, "step_6"))


def test_cli_resume_mismatch_fails_loudly(tmp_path, capsys):
    d = str(tmp_path)
    train.main(_CLI + ["--steps", "2", "--checkpoint-dir", d])
    with pytest.raises(SystemExit, match="env.*catch.*gridworld"):
        train.main(["--env", "gridworld", "--device", "cpu", "--batch", "8",
                    "--steps", "4", "--checkpoint-dir", d, "--resume"])
    with pytest.raises(ValueError, match="params/"):   # another agent
        train.main(_CLI + ["--agent", "deep", "--steps", "4",
                           "--checkpoint-dir", d, "--resume"])
    with pytest.raises(SystemExit):
        train.main(_CLI + ["--steps", "4", "--resume"])
    assert "--resume requires --checkpoint-dir" in capsys.readouterr().err


def test_cli_resume_without_checkpoint_starts_fresh(tmp_path, capsys):
    runtime = train.main(_CLI + ["--steps", "1", "--checkpoint-dir",
                                 str(tmp_path / "empty"), "--resume"])
    assert "starting fresh" in capsys.readouterr().out
    assert runtime.start_step == 0
    assert ckpt_lib.is_complete(str(tmp_path / "empty" / "step_1"))
