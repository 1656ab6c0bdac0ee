"""The LM paths' data against the JAX reference, bitwise: the synthetic
corpus, the packed batch stream (also across ``state_dict`` /
``load_state_dict``), the token-MDP episode batch, the token-task reward
and the token-MDP env (driven from the same states, actions and random
draws as the eager JAX step, auto-reset steps included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sources as jsources
from repro.data import synthetic as jsyn
from repro.envs import token_mdp as jtoken
from repro_torch.core import sources as tsources
from repro_torch.data import synthetic as tsyn
from repro_torch.envs import token_mdp as ttoken

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("vocab,length,seed,branching", [
    (512, 5000, 1, 4), (37, 777, 5, 2), (32000, 3000, 0, 4),
    (256000, 20000, 1, 4)])
def test_markov_corpus_bitwise(vocab, length, seed, branching):
    got = tsyn.markov_corpus(vocab, length, seed=seed, branching=branching)
    want = jsyn.markov_corpus(vocab, length, seed=seed, branching=branching)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _take(it, n):
    return [next(it)["tokens"] for _ in range(n)]


def test_packed_batch_iterator_bitwise_and_across_state_dict():
    corpus = tsyn.markov_corpus(512, 4000, seed=1)
    t_it = tsyn.PackedBatchIterator(corpus, 4, 16, seed=3)
    j_it = jsyn.PackedBatchIterator(corpus, 4, 16, seed=3)
    try:
        for got, want in zip(_take(t_it, 5), _take(j_it, 5)):
            assert got.shape == (4, 17)
            np.testing.assert_array_equal(got, want)
        # the port's state restores into the reference and back
        t_state, j_state = t_it.state_dict(), j_it.state_dict()
        assert t_state == j_state == {"kind": "PackedBatchIterator",
                                      "seed": 3, "offset": 5}
        t_rest = tsyn.PackedBatchIterator(corpus, 4, 16, seed=99)
        j_rest = jsyn.PackedBatchIterator(corpus, 4, 16, seed=99)
        try:
            t_rest.load_state_dict(j_state)
            j_rest.load_state_dict(t_state)
            want = _take(j_it, 4)
            for a, b, c, d in zip(_take(t_it, 4), _take(t_rest, 4),
                                  _take(j_rest, 4), want):
                for x in (a, b, c):
                    np.testing.assert_array_equal(x, d)
        finally:
            t_rest.close()
            j_rest.close()
        with pytest.raises(ValueError, match="same data pipeline"):
            t_it.load_state_dict({"kind": "OtherIterator"})
    finally:
        t_it.close()
        j_it.close()


def test_rl_episode_batch_bitwise():
    got = tsyn.rl_episode_batch(np.random.default_rng(4), 3, 12, 97)
    want = jsyn.rl_episode_batch(np.random.default_rng(4), 3, 12, 97)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("vocab", [512, 151936])
def test_token_task_reward_bitwise(vocab):
    tokens = np.random.default_rng(2).integers(0, vocab, (6, 33))
    # plant hits: each next token is the affine target half the time
    hit = np.random.default_rng(3).random((6, 32)) < 0.5
    for t in range(32):
        target = (5 * tokens[:, t] + 3) % vocab
        tokens[:, t + 1] = np.where(hit[:, t], target, tokens[:, t + 1])
    want = np.asarray(jsources.token_task_reward(jnp.asarray(tokens), vocab))
    got = tsources.token_task_reward(torch.from_numpy(tokens), vocab)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


def test_token_mdp_env_matches_jax_bitwise():
    vocab, b, ep_len = 97, 8, 5
    jenv = jtoken.make(vocab, ep_len=ep_len)
    tenv = ttoken.make(vocab, ep_len=ep_len)
    assert (tenv.num_actions, tenv.obs_shape) == (jenv.num_actions,
                                                  jenv.obs_shape)

    def reset_draws(keys):   # mirrors repro/envs/token_mdp.py::_reset
        return {"token": torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.randint(k, (), 0, vocab))(keys)))}

    keys = jax.random.split(jax.random.PRNGKey(0), b)
    jstate, jobs = jax.vmap(jenv.reset)(keys)
    tstate, tobs = tenv.reset_from(reset_draws(keys))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    jstep = jax.vmap(jenv.step)          # eager, as tests/test_torch_envs.py
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(2)
    resets = rewards = 0
    for _ in range(3 * ep_len):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, b)
        # half the actions hit the affine target
        target = (5 * tobs.numpy() + 3) % vocab
        action = np.where(rng.random(b) < 0.5, target,
                          rng.integers(0, vocab, b)).astype(np.int32)
        jstate, jobs, jrew, jdone = jstep(jstate, jnp.asarray(action), keys)
        # auto_reset splits each key into (transition, reset) keys
        _, k2 = jax.vmap(jax.random.split, out_axes=1)(keys)
        tstate, tobs, trew, tdone = tenv.step_from(
            tstate, torch.from_numpy(action), {}, reset_draws(k2))
        for name, j, t in zip(jstate._fields, jstate, tstate):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        assert trew.dtype == torch.float32
        resets += int(tdone.sum())
        rewards += int(trew.sum())
    assert resets == 3 * b and rewards > 0


def test_token_mdp_generator_reset_and_step():
    env = ttoken.make(11)
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(20_000, gen, "cpu")
    freq = np.bincount(obs.numpy(), minlength=11) / 20_000
    np.testing.assert_allclose(freq, 1 / 11, atol=0.02)
    state, obs, reward, done = env.step(state, (5 * obs + 3) % 11, gen)
    assert (reward == 1).all() and not done.any() and (state.t == 1).all()
