"""The LM sources of the port.

``GeneratorSource`` (the LLM policy's episodes from the decode session):
the rollout is time-major with the contract's types, ``action[t] ==
obs[t+1]``, ``done`` is set at the last step only, the reward is the token
task's, and every behavior log-prob equals the log-prob that the port's
own full-sequence forward gives the sampled token (float32, 1e-5) — also
after the learner has moved the weights in place, which the session reads
without a copy. Its generator state resumes the exact episode stream.
Its ``temperature`` and ``reward_fn`` (the reference's arguments) change
the behavior log-probs and the rewards as they do there, and their
defaults change nothing, bit for bit.

``DataSource`` over the packed batch iterator: its state nests the
iterator's, so a restored source hands out the same batches; a
checkpoint of another source kind is refused, and a stopped source
serves again from where it stopped.
The two frameworks' samplers draw different numbers from a seed, so
the decode itself is held to the reference teacher-forced, in
tests/test_torch_model.py."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import sources
from repro_torch.data import PackedBatchIterator, markov_corpus
from repro_torch.models import model as tmodel

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

T, B = 12, 3


def _setup(arch="qwen3-4b", attn="kernel"):
    cfg = dataclasses.replace(tconfigs.get_reduced_config(arch),
                              attn_impl=attn, ssd_impl=attn)
    return cfg, tmodel.init(cfg, seed=0)


def _full_forward_logprob(params, cfg, obs, temperature=1.0):
    with torch.no_grad():
        tokens = obs.T.long()                                # (B, T+1)
        logits = tmodel.apply_lm(params, tokens[:, :-1], cfg=cfg)[0]
        lp = torch.log_softmax(logits / temperature, dim=-1)
        return lp.gather(-1, tokens[:, 1:, None])[..., 0].T  # (T, B)


def _episode_length(arch):
    # Mamba2 and mLSTM: one whole chunk
    return 16 if arch in ("zamba2-2.7b", "xlstm-125m") else T


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b", "xlstm-125m"])
def test_generator_rollout_contract(arch):
    cfg, params = _setup(arch)
    t = _episode_length(arch)
    src = sources.GeneratorSource(cfg, batch_size=B, episode_length=t,
                                  seed=7)
    for _ in range(2):
        r = src.next_batch(params)
        assert r["obs"].shape == (t + 1, B) and r["obs"].dtype == torch.int32
        for k in ("action", "behavior_logprob", "reward", "done"):
            assert r[k].shape == (t, B), k
        assert r["action"].dtype == torch.int32
        assert r["behavior_logprob"].dtype == torch.float32
        assert r["reward"].dtype == torch.float32
        assert r["done"].dtype == torch.bool
        assert torch.equal(r["action"], r["obs"][1:])
        assert r["done"][-1].all() and not r["done"][:-1].any()
        assert torch.equal(r["reward"], sources.token_task_reward(
            r["obs"].T, cfg.vocab_size).T)
        np.testing.assert_allclose(
            r["behavior_logprob"].numpy(),
            _full_forward_logprob(params, cfg, r["obs"]).numpy(),
            rtol=1e-5, atol=1e-5)
        with torch.no_grad():       # the learner's in-place update
            for p in params.parameters():
                p.add_(0.01 * torch.sign(p))


@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-125m"])
def test_generator_temperature_and_reward_fn(arch):
    """The defaults are bitwise today's stream; temperature 0.5 samples
    from and records log softmax(logits / 0.5); ``reward_fn`` gets the
    (B, T+1) tokens on the session's device and its (B, T) rewards come
    back time-major."""
    cfg, params = _setup(arch)
    t = _episode_length(arch)
    seen = []

    def parity(tokens):
        seen.append(tokens)
        return (tokens[:, 1:] % 2 == 0).float()

    plain = sources.GeneratorSource(cfg, batch_size=B, episode_length=t,
                                    seed=7)
    explicit = sources.GeneratorSource(
        cfg, batch_size=B, episode_length=t, seed=7, temperature=1.0,
        reward_fn=lambda tok: sources.token_task_reward(tok, cfg.vocab_size))
    cold = sources.GeneratorSource(cfg, batch_size=B, episode_length=t,
                                   seed=7, temperature=0.5, reward_fn=parity)
    ra, rb, rc = (s.next_batch(params) for s in (plain, explicit, cold))
    for k in ra:
        assert torch.equal(ra[k], rb[k]), k
    np.testing.assert_allclose(
        rc["behavior_logprob"].numpy(),
        _full_forward_logprob(params, cfg, rc["obs"], 0.5).numpy(),
        rtol=1e-5, atol=1e-5)
    assert len(seen) == 1 and seen[0].shape == (B, t + 1)
    assert seen[0].device == next(params.parameters()).device
    assert torch.equal(seen[0], rc["obs"].T.to(seen[0].dtype))
    assert torch.equal(rc["reward"], (rc["obs"][1:] % 2 == 0).float())


def test_generator_state_resumes_the_episode_stream():
    cfg, params = _setup()
    a = sources.GeneratorSource(cfg, batch_size=B, episode_length=T, seed=7)
    a.next_batch(params)
    state = a.state_dict()
    assert state["kind"] == "GeneratorSource"
    b = sources.GeneratorSource(cfg, batch_size=B, episode_length=T, seed=99)
    b.load_state_dict({k: (np.asarray(v) if isinstance(v, torch.Tensor)
                           else v) for k, v in state.items()})
    for _ in range(2):
        ra, rb = a.next_batch(params), b.next_batch(params)
        for k in ra:
            assert torch.equal(ra[k], rb[k]), k
    with pytest.raises(ValueError, match="same source flags"):
        b.load_state_dict({"kind": "DeviceSource"})


def test_lm_rl_step_from_rollout_hands_over_batch_major():
    seen = {}

    def step(params, opt_state, step_i, batch):
        seen.update(batch)
        return params, opt_state, {}

    rollout = {"obs": torch.arange(12).reshape(4, 3),
               "action": torch.arange(9).reshape(3, 3) + 3,
               "behavior_logprob": torch.zeros(3, 3),
               "reward": torch.ones(3, 3),
               "done": torch.zeros(3, 3, dtype=torch.bool)}
    sources.lm_rl_step_from_rollout(step)(None, None, 0, rollout)
    assert set(seen) == {"tokens", "behavior_logprob", "reward", "done"}
    assert torch.equal(seen["tokens"], rollout["obs"].T)
    assert seen["reward"].shape == (3, 3)


def test_data_source_state_nests_the_iterator():
    corpus = markov_corpus(64, 2000, seed=1)

    def make(seed):
        it = PackedBatchIterator(corpus, 2, 8, seed=seed)
        return sources.DataSource(it, frames_per_batch=16,
                                  device=torch.device("cpu"))

    a, b = make(0), make(5)
    try:
        for _ in range(3):
            a.next_batch(None)
        state = a.state_dict()
        assert state == {"kind": "DataSource", "iterator": {
            "kind": "PackedBatchIterator", "seed": 0, "offset": 3}}
        b.load_state_dict(state)
        for _ in range(3):
            assert torch.equal(a.next_batch(None)["tokens"],
                               b.next_batch(None)["tokens"])
        with pytest.raises(ValueError, match="same source flags"):
            b.load_state_dict({"kind": "GeneratorSource"})
    finally:
        a.stop()
        b.stop()


def test_data_source_serves_again_after_stop():
    """``stop`` closes the iterator's thread; the next batch reopens the
    stream where it stopped, so the batches are those of a run that never
    stopped."""
    corpus = markov_corpus(64, 2000, seed=1)
    a, b = (sources.DataSource(PackedBatchIterator(corpus, 2, 8, seed=3),
                               frames_per_batch=16,
                               device=torch.device("cpu"))
            for _ in range(2))
    try:
        want = [a.next_batch(None)["tokens"] for _ in range(4)]
        got = [b.next_batch(None)["tokens"] for _ in range(2)]
        b.stop()
        assert not b._it._thread.is_alive()
        got += [b.next_batch(None)["tokens"] for _ in range(2)]
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert b.state_dict()["iterator"]["offset"] == 4
    finally:
        a.stop()
        b.stop()
