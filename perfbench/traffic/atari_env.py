"""An Atari-shaped environment on the device, batched over B episodes,
with the interface of ``repro_torch.envs.base`` (the benchmark stands in
for ALE, which the repository does not have).

From ``seed``: a bank of ``frames`` frames (84 x 84, float32 in [0, 1))
on the device and an action label for each. An observation is the stack
of an episode's last four frames, (B, 84, 84, 4). A step moves to frame
``(draw + action) % frames``; its reward is 1 where the action equals the
label of the newest frame of the observation it acted on, else 0. An
episode's length is drawn at its reset from a Pareto tail,
``min_len + scale * (U ** (-1 / alpha) - 1)`` capped at ``max_len``;
when it ends the step returns done and the first observation of the
next episode (the auto-reset of ``envs/base.py``).

Each frame carries its index in its top-left pixel (index / frames, exact
in float32), so ``rule_errors`` can check a rollout against this rule
without the draws: the rewards, and the frame stack's shift from one
observation to the next.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class State(NamedTuple):
    hist: torch.Tensor      # (B, 4) int64 frame indices, oldest first
    t: torch.Tensor         # (B,) int64 steps taken in the episode
    length: torch.Tensor    # (B,) int64 the episode's length


class Bank(NamedTuple):
    frames: torch.Tensor    # (N, H, W) float32
    labels: torch.Tensor    # (N,) int64


def make_bank(params: dict, obs_shape, num_actions: int, seed: int,
              device) -> Bank:
    n = int(params["frames"])
    h, w, _ = obs_shape
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.rand((n, h, w), generator=gen, device=device)
    frames[:, 0, 0] = torch.arange(n, device=device, dtype=torch.float32) / n
    labels = torch.randint(0, num_actions, (n,), generator=gen, device=device)
    return Bank(frames, labels)


def make(params: dict, obs_shape, num_actions: int, seed: int, device):
    """The environment (a ``repro_torch.envs.base.Env``) and its bank."""
    from repro_torch.envs.base import Env

    bank = make_bank(params, obs_shape, num_actions, seed, device)
    n, stack = bank.frames.shape[0], obs_shape[-1]
    min_len, max_len = int(params["min_len"]), int(params["max_len"])
    scale, alpha = float(params["scale"]), float(params["alpha"])

    def obs_of(hist):
        return bank.frames[hist].permute(0, 2, 3, 1)        # (B, H, W, 4)

    def draw_reset(batch, gen, dev):
        u = torch.rand((batch,), generator=gen, device=dev).clamp_(min=1e-6)
        return {"first": torch.randint(0, n, (batch,), generator=gen,
                                       device=dev),
                "u": u}

    def reset_from(draws):
        first = draws["first"]
        tail = scale * (torch.pow(draws["u"], -1.0 / alpha) - 1.0)
        length = torch.clamp(min_len + tail, max=max_len).long()
        hist = first[:, None].expand(-1, stack).contiguous()
        state = State(hist, torch.zeros_like(first), length)
        return state, obs_of(hist)

    def draw_step(batch, gen, dev):
        return {"next": torch.randint(0, n, (batch,), generator=gen,
                                      device=dev)}

    def transition(state, action, draws):
        action = action.long()
        reward = (action == bank.labels[state.hist[:, -1]]).float()
        frame = torch.remainder(draws["next"] + action, n)
        hist = torch.cat([state.hist[:, 1:], frame[:, None]], dim=1)
        t = state.t + 1
        done = t >= state.length
        return State(hist, t, state.length), obs_of(hist), reward, done

    env = Env(draw_reset=draw_reset, reset_from=reset_from,
              draw_step=draw_step, transition=transition,
              num_actions=num_actions, obs_shape=tuple(obs_shape))
    return env, bank


@torch.no_grad()
def rule_errors(batch: dict, bank: Bank) -> int:
    """Transitions of a time-major rollout (obs (T+1, B, H, W, 4)) that
    break the rule: a reward other than the rule's for the action taken,
    or a next observation whose frames are not the stack shifted by one
    (the fresh episode's four equal frames after done)."""
    n = bank.frames.shape[0]
    obs = batch["obs"].to(bank.frames.device)
    ids = torch.round(obs[:, :, 0, 0, :] * n).long()          # (T+1, B, 4)
    action = batch["action"].to(ids.device).long()
    reward = batch["reward"].to(ids.device)
    done = batch["done"].to(ids.device)
    want = (action == bank.labels[ids[:-1, :, -1]]).float()
    bad = (reward != want)
    shifted = (ids[1:, :, :-1] == ids[:-1, :, 1:]).all(-1)
    fresh = (ids[1:] == ids[1:, :, :1]).all(-1)
    bad |= torch.where(done, ~fresh, ~shifted)
    return int(bad.sum())
