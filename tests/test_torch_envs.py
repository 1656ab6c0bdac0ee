"""Batched tensor envs of the PyTorch port against the JAX envs: driven
from the same states, actions and random draws (the JAX keys' draws are
computed and injected into the port), every obs, reward, done and next
state must match bitwise, auto-reset steps included. The port's own
generator-driven resets get a coarse statistical check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import catch as jcatch
from repro.envs import gridworld as jgrid
from repro_torch.envs import catch as tcatch
from repro_torch.envs import gridworld as tgrid

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


def _catch_reset_draws(keys):
    return {"ball_x": jax.vmap(
        lambda k: jax.random.randint(k, (), 0, jcatch.COLS))(keys)}


def _catch_step_draws(keys):
    del keys
    return {}


def _grid_reset_draws(keys):
    def one(key):      # mirrors repro/envs/gridworld.py::_reset
        ks = jax.random.split(key, 3)
        return (jax.random.randint(ks[0], (2,), 0, jgrid.SIZE),
                jax.random.randint(ks[1], (jgrid.NUM_FOOD, 2), 0,
                                   jgrid.SIZE),
                jax.random.randint(ks[2], (2,), 0, jgrid.SIZE))
    agent, food, hazard = jax.vmap(one)(keys)
    return {"agent": agent, "food": food, "hazard": hazard}


def _grid_step_draws(keys):   # the food respawn draw of _step's key
    return {"food": jax.vmap(lambda k: jax.random.randint(
        k, (jgrid.NUM_FOOD, 2), 0, jgrid.SIZE))(keys)}


ENVS = {
    # name: (jax module, port module, reset draws, step draws, steps)
    "catch": (jcatch, tcatch, _catch_reset_draws, _catch_step_draws, 24),
    "gridworld": (jgrid, tgrid, _grid_reset_draws, _grid_step_draws, 20),
}


def _torch(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _assert_state_equal(jstate, tstate):
    assert jstate._fields == tstate._fields
    for name, j, t in zip(jstate._fields, jstate, tstate):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_transitions_match_jax_bitwise(name):
    jmod, tmod, reset_draws, step_draws, steps = ENVS[name]
    jenv, tenv = jmod.make(), tmod.make()
    assert tenv.obs_shape == jenv.obs_shape
    assert tenv.num_actions == jenv.num_actions
    b = 16
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    tstate, tobs = tenv.reset_from(_torch(reset_draws(keys)))
    _assert_state_equal(jstate, tstate)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    if name == "gridworld":   # start near the time limit: resets come soon
        t0 = 85 + np.arange(b) % 10
        jstate = jstate._replace(t=jnp.asarray(t0, jnp.int32))
        tstate = tstate._replace(t=torch.from_numpy(t0))

    # Eager, not jitted: under jit XLA turns gridworld's time channel
    # 1 - t / MAX_STEPS into an FMA with the rounded reciprocal, one ulp
    # off the division the source writes (and the port computes).
    jstep = jax.vmap(jenv.step)
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(2)
    resets = 0
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, b)
        action = rng.integers(0, jenv.num_actions, (b,)).astype(np.int32)
        jstate, jobs, jrew, jdone = jstep(jstate, jnp.asarray(action), keys)
        # auto_reset splits each key into (transition, reset) keys
        k1, k2 = jax.vmap(jax.random.split, out_axes=1)(keys)
        tstate, tobs, trew, tdone = tenv.step_from(
            tstate, torch.from_numpy(action), _torch(step_draws(k1)),
            _torch(reset_draws(k2)))
        _assert_state_equal(jstate, tstate)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        assert tobs.dtype == torch.float32 and trew.dtype == torch.float32
        resets += int(tdone.sum())
    assert resets > 0, "the run must cover auto-reset steps"


def test_catch_reset_distribution():
    env = tcatch.make()
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(20_000, gen, "cpu")
    freq = np.bincount(state.ball_x.numpy(), minlength=tcatch.COLS) / 20_000
    np.testing.assert_allclose(freq, 1 / tcatch.COLS, atol=0.02)
    assert (state.ball_y == 0).all()
    assert (state.paddle_x == tcatch.COLS // 2).all()
    assert obs.shape == (20_000, tcatch.ROWS, tcatch.COLS, 1)
    assert (obs.sum((1, 2, 3)) == 2).all()   # ball + paddle pixels


def test_gridworld_reset_distribution_and_step():
    env = tgrid.make()
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(20_000, gen, "cpu")
    for field in (state.agent, state.food, state.hazard):
        vals = field.reshape(-1).numpy()
        freq = np.bincount(vals, minlength=tgrid.SIZE) / vals.size
        np.testing.assert_allclose(freq, 1 / tgrid.SIZE, atol=0.01)
    assert state.food_alive.all() and (state.t == 0).all()
    np.testing.assert_array_equal(obs[..., 3].numpy(), 1.0)
    action = torch.randint(0, env.num_actions, (20_000,), generator=gen)
    state, obs, reward, done = env.step(state, action, gen)
    assert obs.shape == (20_000,) + env.obs_shape
    assert reward.shape == done.shape == (20_000,)
    assert set(np.unique(reward.numpy())) <= {-1.0, 0.0, 1.0, 2.0, 3.0}
