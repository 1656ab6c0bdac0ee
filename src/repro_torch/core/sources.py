"""Rollout sources — the actor side of the IMPALA split, behind one
contract.

Every source produces *canonical time-major rollouts*: a dict with

  obs              (T+1, B, *obs_shape)   observations (obs[T] bootstraps)
  action           (T, B) int32
  behavior_logits  (T, B, A) float32
  reward           (T, B) float32
  done             (T, B) bool

exactly the learner-input layout of the paper's §2, so the ``Runtime``
(core/runtime.py) is indifferent to *how* rollouts are produced.

``DeviceSource`` is the on-device unroll (core/rollout.py), with optional
double-buffered dispatch: unroll N+1 is dispatched with the params of step
N-1 before the learner consumes unroll N, so acting and learning overlap at
a one-step parameter lag (V-trace corrects the resulting off-policyness —
the IMPALA argument). Host actors, replay and the sharded source are not
ported yet.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Protocol, runtime_checkable

import torch


@runtime_checkable
class RolloutSource(Protocol):
    """The contract the Runtime consumes.

    ``next_batch(params)`` hands the source the learner's *current*
    parameters (the agent module) and returns one rollout batch. Sources
    are free to act with lagged parameters (that is the point of the
    decoupled architecture); the rollout's behavior outputs must describe
    the policy that actually produced it.
    """

    frames_per_batch: int

    def start(self, params) -> None: ...

    def next_batch(self, params) -> Dict[str, Any]: ...

    def stop(self) -> None: ...


def check_rollout(rollout: Dict[str, Any], unroll_length: int,
                  batch_size: int) -> None:
    """Check the canonical time-major contract (used by tests and as the
    executable spec of the layout above); raises ValueError."""
    t, b = unroll_length, batch_size
    expect = [
        ("obs", tuple(rollout["obs"].shape[:2]), (t + 1, b)),
        ("action", tuple(rollout["action"].shape), (t, b)),
        ("action", rollout["action"].dtype, torch.int32),
        ("reward", tuple(rollout["reward"].shape), (t, b)),
        ("reward", rollout["reward"].dtype, torch.float32),
        ("done", tuple(rollout["done"].shape), (t, b)),
        ("done", rollout["done"].dtype, torch.bool),
        ("behavior_logits", tuple(rollout["behavior_logits"].shape[:2]),
         (t, b)),
        ("behavior_logits", rollout["behavior_logits"].dtype,
         torch.float32),
    ]
    bad = [f"{k}: {got} != {want}" for k, got, want in expect if got != want]
    if bad:
        raise ValueError("rollout breaks the time-major contract: "
                         + "; ".join(bad))


# ---------------------------------------------------------------------------
# On-device actors


class DeviceSource:
    """Single-device unroll source.

    Synchronous (``pipelined=False``): ``next_batch(params)`` dispatches one
    unroll with the given params and returns it — unroll N sees the params
    of step N.

    Double-buffered (``pipelined=True``): one unroll is always in flight.
    ``next_batch(params)`` returns the previously dispatched unroll and
    immediately dispatches the next one, so from step 1 onward the consumed
    rollout was generated with the params of the *previous* learner step
    (parameter lag 1). The unroll only enqueues device work, so the card
    runs it while the host goes on to the learner step. With frozen params
    both modes produce identical rollout streams (same generator draws).

    ``param_sync_every=k`` refreshes the behavior params only every k-th
    dispatch — the actor-lag knob.

    The actors act with their own copy of the agent (TorchBeast's
    ``actor_model`` beside the ``learner_model``). The learner updates its
    parameters in place, so each sync copies the learner's ``state_dict``
    into the actor copy; between syncs the actors keep the parameters of
    the last sync, whatever the learner does meanwhile.
    """

    def __init__(self, unroll: Callable, carry, generator: torch.Generator,
                 actor: torch.nn.Module, *, unroll_length: int,
                 batch_size: int, pipelined: bool = True,
                 param_sync_every: int = 1):
        self._unroll = unroll
        self._carry = carry
        self._gen = generator
        self._actor = actor
        self.unroll_length = unroll_length
        self.batch_size = batch_size
        self.frames_per_batch = unroll_length * batch_size
        self.pipelined = pipelined
        self.param_sync_every = max(1, param_sync_every)
        self._dispatches = 0
        self._pending = None

    @classmethod
    def for_env(cls, env, agent: torch.nn.Module, *, unroll_length: int,
                batch_size: int, seed: int, **kwargs) -> "DeviceSource":
        """Build the feed-forward-agent source from an Env and the learner's
        agent, on the agent's device, drawing from a generator seeded with
        ``seed``."""
        from repro_torch.core import rollout as rollout_lib
        device = next(agent.parameters()).device
        gen = torch.Generator(device=device).manual_seed(seed)
        carry = rollout_lib.env_reset_batch(env, gen, batch_size, device)
        actor = copy.deepcopy(agent).requires_grad_(False)
        unroll = rollout_lib.make_unroll(env, unroll_length)
        return cls(unroll, carry, gen, actor, unroll_length=unroll_length,
                   batch_size=batch_size, **kwargs)

    def _dispatch(self, params):
        if self._dispatches % self.param_sync_every == 0:
            self._actor.load_state_dict(params.state_dict())
        self._dispatches += 1
        self._carry, rollout = self._unroll(self._actor, self._carry,
                                            self._gen)
        return rollout

    def start(self, params) -> None:
        del params  # first dispatch happens lazily in next_batch

    def next_batch(self, params):
        if not self.pipelined:
            return self._dispatch(params)
        if self._pending is None:
            self._pending = self._dispatch(params)
        rollout, self._pending = self._pending, self._dispatch(params)
        return rollout

    def stop(self) -> None:
        """Drop the in-flight rollout and the dispatch count: a stop/start
        cycle must behave like a fresh source, so its first dispatch syncs
        the actors instead of resuming the ``param_sync_every`` cadence with
        last run's parameters."""
        self._pending = None
        self._dispatches = 0
