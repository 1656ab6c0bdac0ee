"""Rollout sources — the actor side of the IMPALA split, behind one
contract.

Every source produces *canonical time-major rollouts*: a dict with

  obs              (T+1, B, *obs_shape)   observations (obs[T] bootstraps)
  action           (T, B) int32
  behavior_logits  (T, B, A) float32
  reward           (T, B) float32
  done             (T, B) bool

exactly the learner-input layout of the paper's §2, so the ``Runtime``
(core/runtime.py) is indifferent to *how* rollouts are produced:

  ``DeviceSource``   — the on-device unroll (core/rollout.py), with
                       optional double-buffered dispatch: unroll N+1 is
                       dispatched with the params of step N-1 before the
                       learner consumes unroll N, so acting and learning
                       overlap at a one-step parameter lag (V-trace
                       corrects the resulting off-policyness — the IMPALA
                       argument).
  ``HostLoopSource`` — MonoBeast/PolyBeast host actor threads feeding the
                       inference queue (DynamicBatcher) and the learner
                       queue (BatchingQueue).

SourceState: every source is a stateful, checkpointable object.
``state_dict()`` captures everything the rollout stream depends on — env
carries, generator states, dispatch bookkeeping (the double-buffered
in-flight rollout and the actors' parameter copy) — as a tree of
dicts/lists/tuples/scalars/tensors; ``load_state_dict()`` restores it
into a freshly built source of the same shape. The Runtime saves it inside
every checkpoint (checkpoint.save ``structured=``) and ``train.py
--resume`` restores it, so a killed-and-resumed run replays the exact
batch stream of an uninterrupted one (bit-identical final params). The
one exception is the host-loop path: thread scheduling is not replayable,
so ``HostLoopSource`` restarts its actors fresh and only the learner state
resumes exactly. Replay and the sharded source are not ported yet.
"""

from __future__ import annotations

import copy
import threading
import warnings
from typing import Any, Callable, Dict, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.tree import leaves, rebuild


@runtime_checkable
class RolloutSource(Protocol):
    """The contract the Runtime consumes.

    ``next_batch(params)`` hands the source the learner's *current*
    parameters (the agent module) and returns one rollout batch. Sources
    are free to act with lagged parameters (that is the point of the
    decoupled architecture); the rollout's behavior outputs must describe
    the policy that actually produced it.

    ``state_dict()``/``load_state_dict()`` are the SourceState
    checkpoint/restore protocol (module docstring): a source with no
    resumable state returns ``{"kind": ...}`` and checks only that on
    load, but every source answers.
    """

    frames_per_batch: int

    def start(self, params) -> None: ...

    def next_batch(self, params) -> Dict[str, Any]: ...

    def stop(self) -> None: ...

    def state_dict(self) -> Dict[str, Any]: ...

    def load_state_dict(self, state: Dict[str, Any]) -> None: ...


def _check_kind(state: Dict[str, Any], obj) -> None:
    """Loud resume-composition guard: a checkpoint written by one source
    shape must not be loaded into another (e.g. saved with --actors host,
    resumed with device actors)."""
    kind = state.get("kind") if hasattr(state, "get") else None
    if kind != type(obj).__name__:
        raise ValueError(
            f"checkpoint source state is {kind!r} but this run built "
            f"{type(obj).__name__} — resume with the same source flags "
            "(--actors)")


def _like(template, tree):
    """``tree`` (whose containers degraded to tuples/lists in the
    checkpoint, its leaves to numpy) rebuilt in the structure of
    ``template``, each leaf a tensor on the matching template leaf's
    device — the restore path for env carries (NamedTuple states)."""
    return rebuild(template, iter(
        torch.as_tensor(x).to(t.device)
        for t, x in zip(leaves(template), leaves(tree))))


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
        self._device = next(actor.parameters()).device

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

    # -- SourceState protocol -------------------------------------------------
    #
    # Captured at a step boundary (periodic/final checkpoints are), this is
    # the COMPLETE dispatch state: the env carry and the generator's state,
    # the dispatch counter (param_sync_every cadence), the in-flight
    # double-buffered rollout, and the actors' parameter copy (which lags
    # the learner's when param_sync_every > 1). Restoring all of it makes
    # the resumed rollout stream bit-identical to the uninterrupted one.
    # The tensors are the live ones, valid until the source next
    # dispatches: checkpoint.snapshot copies them.

    def state_dict(self) -> Dict[str, Any]:
        return {
            "kind": type(self).__name__,
            "dispatches": self._dispatches,
            "pending": self._pending,
            "actor": self._actor.state_dict(),
            "stream": {"carry": self._carry,
                       "generator": self._gen.get_state()},
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _check_kind(state, self)
        self._dispatches = int(state["dispatches"])
        self._carry = _like(self._carry, state["stream"]["carry"])
        self._gen.set_state(torch.as_tensor(state["stream"]["generator"],
                                            dtype=torch.uint8).cpu())
        pending = state["pending"]
        self._pending = None if pending is None else {
            k: torch.as_tensor(v).to(self._device)
            for k, v in pending.items()}
        self._actor.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state["actor"].items()})


# ---------------------------------------------------------------------------
# Host-loop (MonoBeast/PolyBeast) actors

# The learner queue holds at most this many rollouts (actors block beyond
# it), and ``next_batch`` gives up after waiting this long for a batch.
_LEARNER_QUEUE_ITEMS = 128
_BATCH_TIMEOUT_S = 60.0


class HostLoopSource:
    """Actor threads + inference queue + learner queue behind the contract.

    The envs run on the CPU in the actor threads (``HostEnv``), as the
    paper's actors do; the policy and the learner run on the agent's
    device. The policy runs on the source's own copy of the agent (the
    actor model beside the learner model): the learner updates its
    parameters in place, so ``next_batch(params)`` copies them into the
    actor copy under a lock that the inference thread holds for each
    forward pass — no forward pass ever sees a half-updated parameter
    set. Actors pick the new parameters up on their next policy
    evaluation, the natural asynchronous parameter lag of the host
    architecture; ``next_batch`` then blocks until the learner queue
    yields a stacked batch, which it moves to the device.

    SourceState: thread scheduling (which actor's rollout lands in which
    batch slot) is not replayable, so the host path cannot promise
    bit-exact resume. ``state_dict`` records only the source kind; actors
    restart fresh on resume while the learner state restores exactly.
    """

    def __init__(self, env, agent: torch.nn.Module, *, num_actors: int,
                 unroll_length: int, batch_size: int, seed: int = 0,
                 inference_timeout_ms: float = 5.0):
        self._env = env
        self._actor = copy.deepcopy(agent).requires_grad_(False)
        self._device = next(agent.parameters()).device
        self._lock = threading.Lock()
        self.num_actors = num_actors
        self.unroll_length = unroll_length
        self.batch_size = batch_size
        self.frames_per_batch = unroll_length * batch_size
        self.seed = seed
        self._inference_timeout_ms = inference_timeout_ms
        self._pool = None
        self._inference_thread = None

    def _sync(self, params) -> None:
        with self._lock:
            self._actor.load_state_dict(params.state_dict())

    def _policy(self, obs: np.ndarray) -> np.ndarray:
        """Runs on the inference thread: (n, *obs) -> (n, A) float32."""
        x = torch.from_numpy(obs).to(self._device)
        with self._lock:
            logits = self._actor(x).policy_logits.float().cpu()
        return logits.numpy()

    def start(self, params) -> None:
        from repro_torch.core.actor_pool import (ActorPool,
                                                 start_inference_thread)
        from repro_torch.core.batcher import BatchingQueue, DynamicBatcher
        from repro_torch.envs.base import HostEnv

        self._sync(params)
        self.inference = DynamicBatcher(
            max_batch_size=self.num_actors,
            timeout_ms=self._inference_timeout_ms)
        self.learner_queue = BatchingQueue(
            self.batch_size, batch_dim=1, max_items=_LEARNER_QUEUE_ITEMS)
        self._pool = ActorPool(
            lambda seed: HostEnv(self._env, seed), self.num_actors,
            self.unroll_length, self.inference, self.learner_queue,
            seed=self.seed)
        self._inference_thread = start_inference_thread(
            self.inference, self._policy, self._device)
        self._pool.start()

    def next_batch(self, params):
        if self._pool is None:
            self.start(params)
        self._sync(params)
        batch = self.learner_queue.get(timeout=_BATCH_TIMEOUT_S)
        if batch is None:
            raise TimeoutError(
                f"no learner batch within {_BATCH_TIMEOUT_S}s "
                f"({self.num_actors} actors, queue "
                f"size {self.learner_queue.size()})")
        return {k: torch.from_numpy(v).to(self._device)
                for k, v in batch.items()}

    def stop(self) -> None:
        """Stop the actor pool AND the inference thread. The pool closes
        the DynamicBatcher (unblocking the thread's ``get_batch``), but the
        thread itself must be joined — otherwise it lingers, evaluating the
        policy after the run has stopped."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.stop()
        thread, self._inference_thread = self._inference_thread, None
        if thread is not None:
            thread.join(timeout=5.0)
            if thread.is_alive():
                # warn, don't raise: stop() runs in Runtime's finally, and
                # raising here would mask the root-cause exception (e.g.
                # the actor TimeoutError a wedged policy eval produced).
                warnings.warn("inference thread did not exit within 5s of "
                              "stop()", RuntimeWarning, stacklevel=2)

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": type(self).__name__}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _check_kind(state, self)
