"""Batched tensor environments on the device.

An Env is a set of plain functions over a batch of B episodes, every
tensor with a leading B dimension and on one device:

  draw_reset(batch, gen, device) -> draws   random numbers a reset consumes
  reset_from(draws)              -> (state, obs)
  draw_step(batch, gen, device)  -> draws   random numbers a transition
                                            consumes (may be empty)
  transition(state, action, draws) -> (state, obs, reward, done)

The draws are kept apart from the transition so that a test can feed the
same numbers to this package and to the JAX reference, whose generator
differs. ``reset(batch, gen, device)`` and ``step(state, action, gen)``
draw from a ``torch.Generator`` and apply them.

Auto-reset semantics: when an episode ends, ``step`` returns done=True and
the obs/state of the freshly reset episode (the vectorised-RL convention
IMPALA's episode definition needs). Obs are (B, H, W, C) float32.

The host-loop (MonoBeast-style) actors wrap an Env with ``HostEnv``: one
episode stream on the CPU behind the Gym step/reset API of TorchBeast's
polybeast_env.py.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch


def _where(done, fresh, old):
    """Per-episode select over a NamedTuple state or a tensor."""
    if isinstance(old, torch.Tensor):
        return torch.where(done.view((-1,) + (1,) * (old.dim() - 1)),
                           fresh, old)
    return type(old)(*(_where(done, f, o) for f, o in zip(fresh, old)))


class Env(NamedTuple):
    draw_reset: Callable[[int, torch.Generator, Any], Dict[str, torch.Tensor]]
    reset_from: Callable[[Dict[str, torch.Tensor]], Tuple[Any, torch.Tensor]]
    draw_step: Callable[[int, torch.Generator, Any], Dict[str, torch.Tensor]]
    transition: Callable[..., Tuple[Any, torch.Tensor, torch.Tensor,
                                    torch.Tensor]]
    num_actions: int
    obs_shape: Tuple[int, ...]

    def reset(self, batch: int, gen: torch.Generator, device):
        return self.reset_from(self.draw_reset(batch, gen, device))

    def step_from(self, state, action, step_draws, reset_draws):
        """One auto-resetting step from given draws (the tests' entry)."""
        new_state, obs, reward, done = self.transition(state, action,
                                                       step_draws)
        reset_state, reset_obs = self.reset_from(reset_draws)
        return (_where(done, reset_state, new_state),
                _where(done, reset_obs, obs), reward, done)

    def step(self, state, action, gen: torch.Generator):
        batch, device = action.shape[0], action.device
        step_draws = self.draw_step(batch, gen, device)
        reset_draws = self.draw_reset(batch, gen, device)
        return self.step_from(state, action, step_draws, reset_draws)


class HostEnv:
    """Imperative Gym-like wrapper over a batched Env at B = 1 on the CPU
    (one episode stream), drawing from its own generator seeded with
    ``seed``. ``reset()`` returns a numpy observation; ``step(action)``
    returns (obs, reward, done, info) with Python scalars.

    This is the object served by the paper's environment servers; here it
    backs the host actor loop (core/actor_pool.py).

    All HostEnvs of a process step one at a time (``_ONE_AT_A_TIME``). A
    step is some sixty tiny torch ops, each of which releases and retakes
    the interpreter lock; with eight actor threads contending for it,
    every handoff costs more than the op, and eight threads stepping
    freely take several times longer per env step, in aggregate, than
    one at a time (``tools/host_env_threads.py`` measures both; PERF.md
    §5). The actors still overlap their env steps with their waits on the
    inference queue.
    """

    _ONE_AT_A_TIME = threading.Lock()

    def __init__(self, env: Env, seed: int = 0):
        self._env = env
        self._gen = torch.Generator().manual_seed(seed)
        self._state = None

    @property
    def num_actions(self):
        return self._env.num_actions

    def reset(self):
        with self._ONE_AT_A_TIME:
            self._state, obs = self._env.reset(1, self._gen, "cpu")
            return obs[0].numpy()

    def step(self, action):
        with self._ONE_AT_A_TIME:
            self._state, obs, reward, done = self._env.step(
                self._state, torch.tensor([int(action)]), self._gen)
            return obs[0].numpy(), float(reward[0]), bool(done[0]), {}
