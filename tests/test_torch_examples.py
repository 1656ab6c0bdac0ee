"""The repository's examples on the port (``repro_torch.examples``) held to
the reference's scripts under ``examples/`` on the CPU:

  (a) the V-trace ablation's two learner steps (``vtrace_ablation``: the
      corrected ``compiled.TrainStep`` and the user-written uncorrected
      step) against the reference's arms as ``examples/vtrace_ablation.py``
      builds them, from the reference's ``init_agent(PRNGKey(0))``
      converted, on one batch of the port's unroll: metrics and
      parameters at 1e-5 (tests/test_torch_learner.py's bar); the
      uncorrected batch's log rho exactly 0; its lagged actor refreshed
      only every k-th step;
  (b) the gridworld example's fused unroll and learner step
      (``compiled.UnrollTrainStep``) bitwise ``make_unroll`` followed by
      the learner step from one state and one generator state, and its
      learner half against the reference's ``make_train_step`` on that
      rollout at 1e-5;
  (c) ``lm_rl_100m.make_100m_config`` equal to the reference's field for
      field, with equal ``param_count()``;
  (d) ``lm_rl_100m``'s affine reward batch (bitwise) and one learner step
      against the reference's jitted ``make_lm_train_step(loss_chunk=
      ep_len)`` at d 64, 2 layers, vocab 64, B 4, ep 8, on the port's
      generated tokens and behaviour log-probs, at
      tests/test_torch_lm_learner.py's ``TOLS`` and ``STEP_ATOL`` rule;
  (e) each example's ``main`` with ``--device cpu`` for a few steps,
      printing the reference's lines; each runs as ``python -m``;
  (f) each ``main`` without ``--device cpu`` raising here (no GPU):
      nothing falls back to the CPU.

The reference's scripts are read, never edited: ``examples/lm_rl_100m.py``
is loaded from its file. The card's side (the graphs bitwise eager, the
launches, the full-width runs) is ``chip_smoke.py`` phase 34."""

import copy
import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.atari_impala import small_train as jsmall_train
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import learner as jlearner
from repro.envs import catch as jcatch
from repro.envs import gridworld as jgridworld
from repro.models import model as jmodel
from repro.models.convnet import init_agent as jinit_agent
from repro.models.convnet import minatar_net as jminatar
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import convert
from repro_torch.convert import lm_state_dict_from_jax
from repro_torch.core import generate as G
from repro_torch.core import learner as tlearner
from repro_torch.core import rollout as trollout
from repro_torch.envs import gridworld as tgridworld
from repro_torch.examples import (lm_rl_100m, minatar_gridworld, quickstart,
                                  serve_batched, vtrace_ablation)
from repro_torch.tree import flatten, map_leaves
from test_torch_lm_learner import STEP_ATOL, TOLS, _assert_params_close

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
ABLATION_STEPS, ABLATION_LR = 700, 5e-3     # the reference's defaults


def _np(batch):
    return {k: np.array(v) for k, v in batch.items()}


def _jax_params(agent):
    # copies: the port's steps update in place what .numpy() would share
    return jax.tree.map(lambda x: jnp.asarray(np.array(x)),
                        convert.state_dict_to_jax(agent.state_dict()))


def _assert_agent_close(agent, jparams, what):
    got = convert.state_dict_to_jax(agent.state_dict())
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams),
                    strict=True):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=what, **TOL)


def _assert_metrics_close(tm, jm, what):
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   err_msg=f"{k} {what}", **TOL)


def _bitwise(a, b, what):
    for (path, x), (_, y) in zip(flatten(a), flatten(b), strict=True):
        assert torch.equal(x, y), f"{what}: {path}"


# ---------------------------------------------------------------------------
# (a) the ablation's arms


def _reference_arms(tc):
    """The reference's two learner steps, as examples/vtrace_ablation.py
    builds them (``train_step``, and ``uncorrected_step`` jitted), and its
    weights from ``init_agent(PRNGKey(0))``."""
    env = jcatch.make()
    init_fn, apply_fn = jminatar(env.obs_shape, env.num_actions)
    params, _ = jinit_agent(init_fn, jax.random.PRNGKey(0))
    opt = jmake_optimizer(tc)
    train_step = jlearner.make_train_step(apply_fn, opt, tc)

    @jax.jit
    def uncorrected_step(params, opt_state, step, batch):
        out = apply_fn(params, batch["obs"][:-1])
        batch = dict(batch, behavior_logits=jax.lax.stop_gradient(
            out.policy_logits))
        return train_step(params, opt_state, step, batch)

    return params, opt, {True: jax.jit(train_step), False: uncorrected_step}


@pytest.mark.parametrize("corrected", [True, False],
                         ids=["vtrace", "uncorrected"])
def test_ablation_step_matches_the_reference_arm(corrected):
    tc = jsmall_train(unroll_length=20, batch_size=32,
                      learning_rate=ABLATION_LR,
                      total_steps=ABLATION_STEPS + 1000)
    jparams, jopt, jsteps = _reference_arms(tc)
    source, step_fn, agent, opt = vtrace_ablation.build(
        corrected, lag=40, steps=ABLATION_STEPS, lr=ABLATION_LR,
        device="cpu")
    agent.load_state_dict(convert.state_dict_from_jax(jparams))
    batch = source.next_batch(agent)
    # behaviour logits off the learner's policy, so that the arms differ
    # (the actors' first sync gave them the learner's own weights)
    noise = np.random.default_rng(3).normal(
        0, 0.5, batch["behavior_logits"].shape).astype(np.float32)
    batch["behavior_logits"] += torch.from_numpy(noise)
    if not corrected:
        # the batch the uncorrected step hands the learner step
        seen = vtrace_ablation.uncorrected(lambda p, o, s, b: b)(
            agent, None, 0, batch)
        log_rho = vtrace_ablation.log_rhos(agent, seen)
        assert torch.equal(log_rho, torch.zeros_like(log_rho))
    jbatch = jax.tree.map(jnp.asarray, _np(batch))
    jparams, _, jm = jsteps[corrected](jparams, jopt.init(jparams),
                                       jnp.int32(0), jbatch)
    _, _, tm = step_fn(agent, opt.init(list(agent.parameters())), 0, batch)
    _assert_metrics_close(tm, jm, "after one step")
    _assert_agent_close(agent, jparams, "after one step")
    assert (float(tm["rho_mean"]) == 1.0) == (not corrected)


def test_lagged_actor_refreshes_every_kth_step():
    """``param_sync_every=lag``: the actors' copy takes the learner's
    weights at every lag-th dispatch and keeps them between, and each
    rollout's behaviour logits are that copy's."""
    lag = 3
    source, step_fn, agent, opt = vtrace_ablation.build(
        True, lag=lag, steps=20, device="cpu")
    opt_state = opt.init(list(agent.parameters()))
    synced = None
    for step in range(2 * lag + 1):
        if step % lag == 0:
            synced = copy.deepcopy(agent)
        batch = source.next_batch(agent)
        _bitwise(source._actor.state_dict(), synced.state_dict(),
                 f"actor at step {step}")
        with torch.no_grad():
            first = synced(batch["obs"][0]).policy_logits
        assert torch.equal(batch["behavior_logits"][0], first)
        if step % lag:
            with torch.no_grad():
                now = agent(batch["obs"][0]).policy_logits
            assert not torch.equal(now, first), f"step {step}"
        agent, opt_state, _ = step_fn(agent, opt_state, step, batch)


# ---------------------------------------------------------------------------
# (b) the fused unroll and learner step


def test_fused_step_is_unroll_then_step_and_matches_jax():
    combined, agent, opt_state, tc = minatar_gridworld.build(
        steps=3, device="cpu")
    opt = combined.train_step.opt
    # the two halves from the same state
    halves = {"agent": copy.deepcopy(agent),
              "opt_state": opt.init(list(agent.parameters())),
              "carry": map_leaves(torch.clone, combined.unroll.carry),
              "gen": torch.Generator().set_state(
                  combined.unroll.generator.get_state())}
    unroll = trollout.make_unroll(tgridworld.make(), tc.unroll_length)
    step_fn = tlearner.make_train_step(opt, tc)
    env = jgridworld.make()
    _, apply_fn = jminatar(env.obs_shape, env.num_actions)
    jtc = jsmall_train(**{f.name: getattr(tc, f.name)
                          for f in dataclasses.fields(tc)})
    jopt = jmake_optimizer(jtc)
    jstep = jax.jit(jlearner.make_train_step(apply_fn, jopt, jtc))
    jparams = _jax_params(agent)
    jstate = jopt.init(jparams)
    for step in range(2):
        _, _, fused = combined(agent, opt_state, step)
        halves["carry"], rollout = unroll(halves["agent"], halves["carry"],
                                          halves["gen"])
        jparams, jstate, jm = jstep(jparams, jstate, jnp.int32(step),
                                    jax.tree.map(jnp.asarray,
                                                 _np(rollout)))
        _, _, split = step_fn(halves["agent"], halves["opt_state"], step,
                              rollout)
        _bitwise(fused, split, f"metrics at step {step}")
        _bitwise(agent.state_dict(), halves["agent"].state_dict(),
                 f"params at step {step}")
        _bitwise(opt_state, halves["opt_state"], f"RMSProp at step {step}")
        _bitwise(combined.unroll.carry, halves["carry"],
                 f"carry at step {step}")
        assert torch.equal(combined.unroll.generator.get_state(),
                           halves["gen"].get_state())
        _assert_metrics_close(split, jm, f"at step {step}")
        _assert_agent_close(agent, jparams, f"after step {step}")
    assert combined.captures == 0                   # none on the CPU


# ---------------------------------------------------------------------------
# (c), (d) the 100M LM policy


def _reference_lm_example():
    spec = importlib.util.spec_from_file_location(
        "reference_lm_rl_100m", os.path.join(ROOT, "examples",
                                             "lm_rl_100m.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dims", [(640, 16, 512), (512, 12, 8192),
                                  (64, 2, 64)],
                         ids=["default", "d512", "tiny"])
def test_100m_config_equals_the_reference(dims):
    want = _reference_lm_example().make_100m_config(*dims)
    got = lm_rl_100m.make_100m_config(*dims)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()


def test_lm_reward_and_step_match_jax():
    """The kernel attention on both sides (the reference's Pallas
    kernels in interpret mode, the port's plain versions)."""
    args = lm_rl_100m._parser().parse_args(
        ["--d-model", "64", "--layers", "2", "--vocab", "64", "--batch",
         "4", "--ep-len", "8", "--steps", "1", "--device", "cpu"])
    cfg, tc, params, opt, opt_state, train_step = lm_rl_100m.build(args)
    jcfg = dataclasses.replace(
        _reference_lm_example().make_100m_config(64, 2, 64),
        attn_impl=cfg.attn_impl)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    params.load_state_dict(lm_state_dict_from_jax(jparams), strict=True)
    prompt, seed = lm_rl_100m.draw(torch.Generator().manual_seed(7), args,
                                   cfg.vocab_size)
    ep = G.generate(params, prompt, seed, cfg=cfg, num_steps=args.ep_len)
    batch = lm_rl_100m.episode_batch(ep, cfg.vocab_size)
    # the reference's reward and done (examples/lm_rl_100m.py:78-82)
    tokens = jnp.asarray(ep["tokens"].numpy())
    target = (5 * tokens[:, :-1] + 3) % jcfg.vocab_size
    reward = (tokens[:, 1:] == target).astype(jnp.float32)
    done = jnp.zeros_like(reward, bool).at[:, -1].set(True)
    np.testing.assert_array_equal(batch["reward"].numpy(), reward)
    np.testing.assert_array_equal(batch["done"].numpy(), done)
    jtc = JTrainConfig(**dataclasses.asdict(tc))
    jopt = jmake_optimizer(jtc)
    jstep = jax.jit(jlearner.make_lm_train_step(jcfg, jopt, jtc,
                                                loss_chunk=args.ep_len))
    jbatch = {"tokens": tokens, "reward": reward, "done": done,
              "behavior_logprob": jnp.asarray(ep["logprob"].numpy())}
    jparams, _, jm = jstep(jparams, jopt.init(jparams), jnp.int32(0),
                           jbatch)
    _, _, tm = train_step(params, opt_state, 0, batch)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   err_msg=k, **TOLS["float32"])
    assert STEP_ATOL == tc.learning_rate / 2
    _assert_params_close(params, jparams, TOLS["float32"], "after one step")


# ---------------------------------------------------------------------------
# (e), (f) the entry points


SMOKE = {
    "quickstart": (quickstart, ["--steps", "8"]),
    "quickstart_elite": (quickstart, ["--steps", "8", "--replay", "elite"]),
    "vtrace_ablation": (vtrace_ablation, ["--steps", "6", "--lag", "2",
                                          "--seeds", "1"]),
    "minatar_gridworld": (minatar_gridworld, ["--steps", "3"]),
    "lm_rl_100m": (lm_rl_100m, ["--d-model", "64", "--layers", "2",
                                "--vocab", "64", "--steps", "2"]),
}


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_example_runs_on_the_cpu(name, capsys):
    module, argv = SMOKE[name]
    out = module.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    if module is quickstart:
        assert lines[0].startswith("== host-loop (MonoBeast) actors")
        assert sum(ln.startswith("step") for ln in lines) == 3 + 8
        assert lines[-1].startswith("done: reward/step=")
        assert lines[-1].endswith("(not solved)") \
            or lines[-1].endswith("(SOLVED)")
        assert out["host"].metrics and np.isfinite(out["reward_per_step"])
    elif module is vtrace_ablation:
        assert lines[0] == ("arm,lag,mean_final_reward_over_1_seeds "
                            "(optimal +0.100)")
        assert [ln.split(",")[:2] for ln in lines[1:]] == [
            ["vtrace", "0"], ["vtrace", "2"], ["uncorrected", "0"],
            ["uncorrected", "2"]]
        assert all(np.isfinite(r["rewards"]).all() for r in out)
    elif module is minatar_gridworld:
        assert [ln.split()[:2] for ln in lines] == [
            ["step", "0"], ["step", "1"], ["step", "2"]]
        assert all("reward/step=" in ln and " fps=" in ln for ln in lines)
    else:
        assert lines[0].startswith("policy: qwen3-100m ~")
        assert [ln.split()[:2] for ln in lines[1:]] == [
            ["step", "0"], ["step", "1"]]
        assert all(" H=" in ln and " tok/s=" in ln for ln in lines[1:])
        assert len(out["rewards"]) == 2


def test_serve_batched_forwards_with_a_warning(capsys):
    argv = ["--arch", "qwen3-4b", "--requests", "3", "--gen-tokens", "4",
            "--device", "cpu"]
    with pytest.warns(DeprecationWarning, match="deprecated"):
        summary = serve_batched.main(argv)
    assert "--reduced" not in argv                  # the caller's list kept
    assert summary["served"] == 3 and summary["prompt_echo_ok"]
    assert summary["device"] == "cpu"
    assert "prompt-echo check: OK" in capsys.readouterr().out


MODULES = {"quickstart": quickstart, "vtrace_ablation": vtrace_ablation,
           "minatar_gridworld": minatar_gridworld,
           "lm_rl_100m": lm_rl_100m, "serve_batched": serve_batched}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
@pytest.mark.parametrize("name", sorted(MODULES))
def test_example_raises_without_a_gpu(name):
    argv = {"quickstart": ["--steps", "1"],
            "vtrace_ablation": ["--steps", "1", "--seeds", "1"],
            "minatar_gridworld": ["--steps", "1"],
            "lm_rl_100m": ["--steps", "1"],
            "serve_batched": ["--requests", "1"]}[name]
    with pytest.raises(RuntimeError, match="CUDA requested"):
        if name == "serve_batched":
            with pytest.warns(DeprecationWarning):
                MODULES[name].main(argv)
        else:
            MODULES[name].main(argv)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_example_runs_as_a_module(name):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--help"],
        capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith("usage: ")
    assert "--device {cuda,cpu}" in run.stdout
