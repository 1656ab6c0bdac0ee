"""Token-MDP: a dense-reward sequence-generation environment for LLM-policy
IMPALA.

State is the current token. The environment rewards emitting the token
``(a * prev + b) mod V`` (a hidden affine chain): +1 for the correct next
token, 0 otherwise. Episodes last EP_LEN steps. A policy must learn the
prev->next mapping — learnable from scratch by a small decoder, and a
shape-compatible stand-in for reward-model-scored generation.

Observation = current token id (the driver feeds the *sequence so far* to
the transformer; the env itself is Markov in the last token). Batched over
B episodes (see envs/base.py); obs are (B,) int64 tokens.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.envs.base import Env

EP_LEN = 32


class TokenState(NamedTuple):
    token: torch.Tensor  # (B,) int64
    t: torch.Tensor      # (B,) int64


def make(vocab_size: int, a: int = 5, b: int = 3, ep_len: int = EP_LEN) -> Env:
    def draw_reset(batch, gen, device):
        return {"token": torch.randint(0, vocab_size, (batch,),
                                       generator=gen, device=device)}

    def reset_from(draws):
        token = draws["token"].long()
        state = TokenState(token, torch.zeros_like(token))
        return state, state.token

    def draw_step(batch, gen, device):
        del batch, gen, device   # the transition is deterministic
        return {}

    def transition(state, action, draws):
        del draws
        target = (a * state.token + b) % vocab_size
        reward = (action.long() == target).float()
        t = state.t + 1
        done = t >= ep_len
        state = TokenState(action.long(), t)
        return state, state.token, reward, done

    return Env(draw_reset=draw_reset, reset_from=reset_from,
               draw_step=draw_step, transition=transition,
               num_actions=vocab_size, obs_shape=())
