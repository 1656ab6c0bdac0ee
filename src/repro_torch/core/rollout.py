"""On-device rollout generation.

The whole actor loop — policy evaluation, action sampling, env step —
runs on the device over B batched envs, as a Python loop over T that
enqueues device work and never waits for it (no ``.item()`` or other host
sync inside the loop), so the host can run ahead of the card.

The rollout layout matches the paper's learner-input dict (§2): time-major
(T+1 obs; T actions/rewards/dones/behavior outputs).

These are the plain functions; ``core/compiled.py::Unroll`` runs one as
the reference jits its unroll, a CUDA graph on the card with the carry
donated (held in static buffers, updated in place).
"""

from __future__ import annotations

from typing import Dict

import torch


def sample_actions(logits, gen: torch.Generator):
    """Categorical sample by Gumbel-max: argmax(logits - log E), with
    E ~ Exp(1) drawn from ``gen`` on the logits' device."""
    e = torch.empty_like(logits, dtype=torch.float32).exponential_(
        generator=gen)
    return torch.argmax(logits.float() - torch.log(e), dim=-1)


def make_unroll(env, unroll_length: int):
    """Build unroll(agent, carry, gen) -> (carry, rollout).

    carry = (env_state, obs) batched over B. rollout dict:
      obs             (T+1, B, *obs_shape)
      action          (T, B) int32
      behavior_logits (T, B, A) float32
      reward, done    (T, B) float32, bool
    """

    def unroll(agent, carry, gen):
        env_state, obs = carry
        steps = {"obs": [], "action": [], "behavior_logits": [],
                 "reward": [], "done": []}
        with torch.no_grad():
            for _ in range(unroll_length):
                out = agent(obs)
                action = sample_actions(out.policy_logits, gen)
                env_state, next_obs, reward, done = env.step(
                    env_state, action, gen)
                steps["obs"].append(obs)
                steps["action"].append(action.int())
                steps["behavior_logits"].append(out.policy_logits.float())
                steps["reward"].append(reward)
                steps["done"].append(done)
                obs = next_obs
        steps["obs"].append(obs)
        rollout = {k: torch.stack(v) for k, v in steps.items()}
        return (env_state, obs), rollout

    return unroll


def make_recurrent_unroll(env, unroll_length: int):
    """Recurrent-agent unroll (TorchBeast's core_state contract): the actor
    threads the LSTM state through the episode and resets it on done, and
    the rollout records the INITIAL core_state so the learner can re-run
    the recurrence from the same point.

    Build unroll(agent, carry, gen) -> (carry, rollout) with carry =
    (env_state, obs, core_state, done); ``unroll.initial_carry(agent,
    env_state, obs)`` starts one (a zero state, no episode ended). The
    rollout adds to ``make_unroll``'s:
      pre_done    (T+1, B) bool  obs[t] starts a fresh episode (the agent
                                 zeroes its state there)
      core_state  (h, c), each (B, core): the state at the unroll's start
    """

    def initial_carry(agent, env_state, obs):
        b = obs.shape[0]
        return (env_state, obs, agent.initial_state(b),
                torch.zeros((b,), dtype=torch.bool, device=obs.device))

    def unroll(agent, carry, gen):
        env_state, obs, core_state, done = carry
        initial_core = core_state
        steps = {"obs": [], "pre_done": [], "action": [],
                 "behavior_logits": [], "reward": [], "done": []}
        with torch.no_grad():
            for _ in range(unroll_length):
                out = agent(obs, core_state, done)
                action = sample_actions(out.policy_logits, gen)
                steps["obs"].append(obs)
                steps["pre_done"].append(done)
                env_state, obs, reward, done = env.step(env_state, action,
                                                        gen)
                steps["action"].append(action.int())
                steps["behavior_logits"].append(out.policy_logits.float())
                steps["reward"].append(reward)
                steps["done"].append(done)
                core_state = out.core_state
        steps["obs"].append(obs)
        steps["pre_done"].append(done)
        rollout = {k: torch.stack(v) for k, v in steps.items()}
        rollout["core_state"] = initial_core
        return (env_state, obs, core_state, done), rollout

    unroll.initial_carry = initial_carry
    return unroll


def env_reset_batch(env, gen: torch.Generator, batch: int, device):
    return env.reset(batch, gen, device)


def episode_returns(rollout) -> Dict[str, torch.Tensor]:
    """Diagnostics: per-batch mean reward and episode termination count."""
    return {
        "reward_per_step": rollout["reward"].mean(),
        "episodes_ended": rollout["done"].sum(),
    }
