"""The port's recurrent agent (TorchBeast's ``core_state`` API: the
MinAtar torso with an LSTM core), its unroll and its learner step against
the JAX reference, from the same weights (converted with
``repro_torch.convert``), all at 1e-5:

* tests/test_recurrent_agent.py's three cases: the state resets where
  ``done`` (and the port's logits equal the reference's); unroll plus
  learner steps stay finite, with the reference's rollout layout; the
  learner's re-run reproduces the behaviour logits (the port's own
  rollouts, and the reference's through the port's agent);
* one JAX rollout stream fed to both learners: loss, every metric and the
  updated params after each of three steps, for the ``scan`` and
  ``kernel`` V-trace impls;
* the learner's form (the torso once over all T+1 steps, the cell in a
  loop) against the agent stepped one observation at a time;
* the converter's round trip of the agent's leaves, bitwise.

The port samples actions by Gumbel-max from a ``torch.Generator``, the
reference from threefry keys, so the two unrolls draw different streams:
parity of the learners is shown on the reference's rollouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.atari_impala import small_train as jsmall_train
from repro.core import learner as jlearner
from repro.core import rollout as jrollout
from repro.envs import catch as jcatch
from repro.models.convnet import init_agent, minatar_lstm_net as jlstm
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import convert
from repro_torch.configs.atari_impala import small_train as tsmall_train
from repro_torch.core import learner as tlearner
from repro_torch.core import rollout as trollout
from repro_torch.envs import catch as tcatch
from repro_torch.models.convnet import minatar_lstm_net as tlstm
from repro_torch.optim import make_optimizer as tmake_optimizer

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
T, B = 9, 4
CFG = dict(unroll_length=T, batch_size=B, learning_rate=5e-3,
           total_steps=10)


def _agents(obs_shape, num_actions, seed=0):
    """The reference's params and the port's agent holding them."""
    init_fn, apply_fn, init_state = jlstm(obs_shape, num_actions)
    params, _ = init_agent(init_fn, jax.random.PRNGKey(seed))
    agent = tlstm(obs_shape, num_actions)
    agent.load_state_dict(convert.state_dict_from_jax(params), strict=True)
    return (apply_fn, init_state, params), agent


def _jax_rollouts(n, seed=1):
    """``n`` consecutive JAX recurrent unrolls on Catch (the second and
    later start from a carried state and done flags)."""
    env = jcatch.make()
    (apply_fn, init_state, params), _ = _agents(env.obs_shape,
                                                env.num_actions)
    key = jax.random.PRNGKey(seed)
    env_state, obs = jrollout.env_reset_batch(env, key, B)
    unroll = jax.jit(jrollout.make_recurrent_unroll(env, apply_fn,
                                                    init_state, T))
    carry = jrollout.make_recurrent_unroll(
        env, apply_fn, init_state, T).initial_carry(env_state, obs, B)
    out = []
    for i in range(n):
        carry, ro = unroll(params, carry, jax.random.PRNGKey(100 + i))
        out.append(jax.tree.map(np.asarray, ro))
    return out


def _to_torch(ro):
    out = {k: torch.from_numpy(np.array(v)) for k, v in ro.items()
           if k != "core_state"}
    out["core_state"] = tuple(torch.from_numpy(np.array(x))
                              for x in ro["core_state"])
    return out


@pytest.fixture(scope="module")
def jax_rollouts():
    return _jax_rollouts(3)


def test_lstm_core_state_resets_on_done():
    (apply_fn, init_state, params), agent = _agents((10, 5, 1), 3)
    obs = np.random.default_rng(1).uniform(size=(2, 10, 5, 1)).astype(
        np.float32)
    ones = np.ones((2, 128), np.float32)
    done = np.array([True, False])
    want = apply_fn(params, jnp.asarray(obs), (jnp.asarray(ones),) * 2,
                    jnp.asarray(done))
    with torch.no_grad():
        st = (torch.from_numpy(ones),) * 2
        out = agent(torch.from_numpy(obs), st, torch.from_numpy(done))
        fresh = agent(torch.from_numpy(obs), agent.initial_state(2))
    np.testing.assert_allclose(out.policy_logits.numpy(),
                               want.policy_logits, **TOL)
    np.testing.assert_allclose(out.baseline.numpy(), want.baseline, **TOL)
    for got, w in zip(out.core_state, want.core_state):
        np.testing.assert_allclose(got.numpy(), w, **TOL)
    # row 0 (done) behaves as if the state were zeroed
    np.testing.assert_allclose(out.policy_logits[0].numpy(),
                               fresh.policy_logits[0].numpy(), rtol=1e-5)
    # row 1 keeps its state (different from fresh)
    assert float((out.policy_logits[1]
                  - fresh.policy_logits[1]).abs().max()) > 1e-6


def _port_unroll(agent, seed=1):
    env = tcatch.make()
    gen = torch.Generator().manual_seed(seed)
    env_state, obs = trollout.env_reset_batch(env, gen, B, "cpu")
    unroll = trollout.make_recurrent_unroll(env, T)
    return unroll, unroll.initial_carry(agent, env_state, obs), gen


def test_recurrent_unroll_and_learner_step(jax_rollouts):
    env = tcatch.make()
    _, agent = _agents(env.obs_shape, env.num_actions)
    tc = tsmall_train(**CFG)
    opt = tmake_optimizer(tc)
    opt_state = opt.init(list(agent.parameters()))
    step_fn = tlearner.make_recurrent_train_step(opt, tc)
    unroll, carry, gen = _port_unroll(agent)
    want = jax_rollouts[0]
    for step in range(3):
        carry, ro = unroll(agent, carry, gen)
        # the reference's layout, key for key
        assert set(ro) == set(want)
        for k, w in want.items():
            got = ro[k] if k != "core_state" else ro[k][0]
            w = w if k != "core_state" else w[0]
            assert tuple(got.shape) == w.shape, k
            assert str(got.dtype).split(".")[-1] == str(w.dtype), k
        agent, opt_state, m = step_fn(agent, opt_state, step, ro)
        assert set(m) == {"loss", "pg_loss", "entropy_loss",
                          "reward_per_step"}
        assert all(bool(torch.isfinite(v)) for v in m.values())


def _relearn(agent, ro):
    """The learner's re-run: the torso once, the cell over T+1 steps."""
    with torch.no_grad():
        feats = agent.features(ro["obs"])
        cs, logits = ro["core_state"], []
        for t in range(feats.shape[0]):
            out = agent.cell(feats[t], cs, ro["pre_done"][t])
            cs = out.core_state
            logits.append(out.policy_logits)
    return torch.stack(logits)


def test_recurrent_learner_reproduces_behavior_logits(jax_rollouts):
    """On-policy contract: the learner's re-run of the recurrence from the
    stored initial core_state reproduces the actor's behaviour logits; on
    the port's second unroll (a carried state and done flags) and on the
    reference's rollouts through the port's agent."""
    env = tcatch.make()
    _, agent = _agents(env.obs_shape, env.num_actions)
    unroll, carry, gen = _port_unroll(agent, seed=2)
    carry, _ = unroll(agent, carry, gen)
    carry, ro = unroll(agent, carry, gen)
    assert bool(ro["pre_done"][1:].any()) or bool(ro["done"].any())
    np.testing.assert_allclose(_relearn(agent, ro)[:T].numpy(),
                               ro["behavior_logits"].numpy(), **TOL)
    for want in jax_rollouts:
        got = _relearn(agent, _to_torch(want))[:T]
        np.testing.assert_allclose(got.numpy(), want["behavior_logits"],
                                   **TOL)


def test_learner_form_matches_stepping_the_agent(jax_rollouts):
    """The torso run once over all (T+1)·B observations, then the cell in
    a loop, against ``agent(obs[t], state, pre_done[t])`` step by step."""
    env = tcatch.make()
    _, agent = _agents(env.obs_shape, env.num_actions)
    ro = _to_torch(jax_rollouts[1])
    cs, logits = ro["core_state"], []
    with torch.no_grad():
        for t in range(T + 1):
            out = agent(ro["obs"][t], cs, ro["pre_done"][t])
            cs = out.core_state
            logits.append(out.policy_logits)
    np.testing.assert_allclose(_relearn(agent, ro).numpy(),
                               torch.stack(logits).numpy(), **TOL)


@pytest.mark.parametrize("vtrace_impl", ["scan", "kernel"])
def test_recurrent_learner_matches_jax(jax_rollouts, vtrace_impl):
    """One stream of JAX rollouts fed to both learners: every metric and
    every parameter after each of three RMSProp steps."""
    env = jcatch.make()
    (apply_fn, _, params), agent = _agents(env.obs_shape, env.num_actions)
    jtc, ttc = jsmall_train(**CFG), tsmall_train(**CFG)
    jopt, topt = jmake_optimizer(jtc), tmake_optimizer(ttc)
    jstep = jax.jit(jlearner.make_recurrent_train_step(
        apply_fn, jopt, jtc, vtrace_impl=vtrace_impl))
    tstep = tlearner.make_recurrent_train_step(topt, ttc,
                                               vtrace_impl=vtrace_impl)
    jstate = jopt.init(params)
    tstate = topt.init(list(agent.parameters()))
    for step, ro in enumerate(jax_rollouts):
        params, jstate, jm = jstep(params, jstate, jnp.int32(step),
                                   jax.tree.map(jnp.asarray, ro))
        agent, tstate, tm = tstep(agent, tstate, step, _to_torch(ro))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       err_msg=f"{k} after step {step}",
                                       **TOL)
        got = convert.state_dict_to_jax(agent.state_dict())
        for leaf, sub in params.items():
            for name, w in sub.items():
                np.testing.assert_allclose(
                    got[leaf][name], np.asarray(w),
                    err_msg=f"{leaf}/{name} after step {step}", **TOL)


def test_converter_round_trip_is_bitwise():
    env = jcatch.make()
    (_, _, params), agent = _agents(env.obs_shape, env.num_actions)
    assert sorted(params) == ["baseline", "conv", "lstm_h", "lstm_x",
                              "policy", "torso"]
    back = convert.state_dict_to_jax(agent.state_dict())
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, got), (_, want) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)
