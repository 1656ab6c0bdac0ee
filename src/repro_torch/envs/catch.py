"""Catch (bsuite-style): a ball falls down a ROWSxCOLS board; the paddle on
the bottom row moves left/stay/right. Reward +1 on catch, -1 on miss, at the
final row only. Observation: (ROWS, COLS, 1) float32 with ball and paddle
pixels set to 1. Batched over B episodes (see envs/base.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.envs.base import Env

ROWS, COLS = 10, 5
NUM_ACTIONS = 3


class CatchState(NamedTuple):
    ball_x: torch.Tensor     # (B,) int64
    ball_y: torch.Tensor     # (B,) int64
    paddle_x: torch.Tensor   # (B,) int64


def _obs(state):
    b = state.ball_x.shape[0]
    rows = torch.arange(b, device=state.ball_x.device)
    board = torch.zeros((b, ROWS, COLS), dtype=torch.float32,
                        device=state.ball_x.device)
    # a device scalar: a Python 1.0 would be copied from the host, which
    # a CUDA graph of the unroll cannot capture
    one = torch.ones((), device=board.device)
    board[rows, state.ball_y, state.ball_x] = one
    board[rows, ROWS - 1, state.paddle_x] = one
    return board[..., None]


def _draw_reset(batch, gen, device):
    return {"ball_x": torch.randint(0, COLS, (batch,), generator=gen,
                                    device=device)}


def _reset_from(draws):
    ball_x = draws["ball_x"].long()
    state = CatchState(ball_x, torch.zeros_like(ball_x),
                       torch.full_like(ball_x, COLS // 2))
    return state, _obs(state)


def _draw_step(batch, gen, device):
    del batch, gen, device   # the transition is deterministic
    return {}


def _transition(state, action, draws):
    del draws
    dx = action.long() - 1  # 0,1,2 -> -1,0,1
    paddle_x = torch.clamp(state.paddle_x + dx, 0, COLS - 1)
    ball_y = state.ball_y + 1
    state = CatchState(state.ball_x, ball_y, paddle_x)
    done = ball_y == ROWS - 1
    hit = (state.ball_x == paddle_x).float() * 2.0 - 1.0
    reward = torch.where(done, hit, torch.zeros_like(hit))
    return state, _obs(state), reward, done


def make() -> Env:
    return Env(draw_reset=_draw_reset, reset_from=_reset_from,
               draw_step=_draw_step, transition=_transition,
               num_actions=NUM_ACTIONS, obs_shape=(ROWS, COLS, 1))
