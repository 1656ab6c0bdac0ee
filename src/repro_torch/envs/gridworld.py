"""MinAtar-style 10x10 grid collection game (the paper's canonical
adaptation target — Figs. 1-2 swap PolyBeast onto MinAtar).

The agent (5 actions: noop/up/down/left/right) collects food (+1) and must
avoid a hazard (-1, ends episode). Episode also ends after MAX_STEPS.
Observation: (10, 10, 4) float32 channels [agent, food, hazard, time-left].
Batched over B episodes (see envs/base.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.envs.base import Env

SIZE = 10
NUM_ACTIONS = 5
NUM_FOOD = 3
MAX_STEPS = 100


class GridState(NamedTuple):
    agent: torch.Tensor       # (B, 2) int64
    food: torch.Tensor        # (B, NUM_FOOD, 2) int64
    food_alive: torch.Tensor  # (B, NUM_FOOD) bool
    hazard: torch.Tensor      # (B, 2) int64
    t: torch.Tensor           # (B,) int64


def _obs(state):
    b, device = state.t.shape[0], state.t.device
    rows = torch.arange(b, device=device)
    board = torch.zeros((b, SIZE, SIZE, 4), dtype=torch.float32,
                        device=device)
    # a device scalar: a Python 1.0 would be copied from the host, which
    # a CUDA graph of the unroll cannot capture
    one = torch.ones((), device=device)
    board[rows, state.agent[:, 0], state.agent[:, 1], 0] = one
    for i in range(NUM_FOOD):   # in order: a later food wins a shared cell
        board[rows, state.food[:, i, 0], state.food[:, i, 1], 1] = \
            state.food_alive[:, i].float()
    board[rows, state.hazard[:, 0], state.hazard[:, 1], 2] = one
    board[..., 3] = (1.0 - state.t.float() / MAX_STEPS)[:, None, None]
    return board


def _draw_reset(batch, gen, device):
    def draw(*shape):
        return torch.randint(0, SIZE, (batch,) + shape, generator=gen,
                             device=device)
    return {"agent": draw(2), "food": draw(NUM_FOOD, 2), "hazard": draw(2)}


def _reset_from(draws):
    agent = draws["agent"].long()
    b = agent.shape[0]
    state = GridState(
        agent, draws["food"].long(),
        torch.ones((b, NUM_FOOD), dtype=torch.bool, device=agent.device),
        draws["hazard"].long(),
        torch.zeros((b,), dtype=torch.long, device=agent.device))
    return state, _obs(state)


def _draw_step(batch, gen, device):
    """The respawn positions of collected food."""
    return {"food": torch.randint(0, SIZE, (batch, NUM_FOOD, 2),
                                  generator=gen, device=device)}


def _transition(state, action, draws):
    # noop/up/down/left/right as (row, col) steps (0,0) (-1,0) (1,0) (0,-1)
    # (0,1), computed from the action on the device (no table to copy)
    a = action.long()
    move = torch.stack([(a == 2).long() - (a == 1).long(),
                        (a == 4).long() - (a == 3).long()], -1)
    agent = torch.clamp(state.agent + move, 0, SIZE - 1)
    on_food = (state.food == agent[:, None]).all(-1) & state.food_alive
    reward = on_food.sum(-1).float()
    food_alive = state.food_alive & ~on_food
    # collected food respawns
    food = torch.where(on_food[..., None], draws["food"].long(), state.food)
    food_alive = food_alive | on_food
    on_hazard = (agent == state.hazard).all(-1)
    reward = reward - on_hazard.float()
    t = state.t + 1
    done = on_hazard | (t >= MAX_STEPS)
    state = GridState(agent, food, food_alive, state.hazard, t)
    return state, _obs(state), reward, done


def make() -> Env:
    return Env(draw_reset=_draw_reset, reset_from=_reset_from,
               draw_step=_draw_step, transition=_transition,
               num_actions=NUM_ACTIONS, obs_shape=(SIZE, SIZE, 4))
